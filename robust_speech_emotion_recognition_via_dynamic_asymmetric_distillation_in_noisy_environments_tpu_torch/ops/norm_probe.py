"""Bandwidth probe of the fused-norm kernels (the counterpart of the JAX
package's ``tools/bench_fused_norm.py``, main and ``--extra``).

    python -m <this package>.ops.norm_probe [--iters 100]

At the two shapes the encoder's LayerNorms have in the fused step (B = 64
clips of 4 s), bf16, it times the kernels of ``ops/fused_norm.py`` beside
their plain versions and prints one line each with the effective rate:
- transformer block LN: (64, 199, 768), residual + affine LN;
- conv stack LN + GELU: (64, 3199, 512), affine LN + tanh-GELU;
- row copy of the latter shape: the bandwidth ceiling.

Runs on the GPU unless the caller passes ``device="cpu"``; times come from
CUDA events on the GPU, from the host clock on the CPU.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch

from ..utils.device import resolve_device
from .fused_norm import copy_rows, fused_layernorm, fused_layernorm_reference

# (rows' leading shape, features) of the two probe shapes
SHAPES: Dict[str, Tuple[int, ...]] = {
    "res_ln": (64, 199, 768),
    "ln_gelu": (64, 3199, 512),
}


def probe_inputs(shapes: Dict[str, Tuple[int, ...]], device: torch.device,
                 seed: int = 0) -> Dict[str, torch.Tensor]:
    """Seeded bf16 activations and f32 affine parameters on ``device``."""
    g = torch.Generator().manual_seed(seed)

    def normal(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g).to(device=device, dtype=dtype)

    (b1, n1, c1), (b2, n2, c2) = shapes["res_ln"], shapes["ln_gelu"]
    return dict(
        x1=normal(b1, n1, c1), res1=normal(b1, n1, c1),
        scale1=normal(c1, dtype=torch.float32), bias1=normal(c1, dtype=torch.float32),
        x2=normal(b2, n2, c2),
        scale2=normal(c2, dtype=torch.float32), bias2=normal(c2, dtype=torch.float32),
    )


def probe_cases(t: Dict[str, torch.Tensor]) -> List[Tuple[str, Callable, int]]:
    """(name, call, bytes it must move) for each probe line."""
    x1, x2 = t["x1"], t["x2"]
    n1 = 3 * x1.numel() * x1.element_size()  # read x and residual, write out
    n2 = 2 * x2.numel() * x2.element_size()  # read x, write out
    res_args = (x1, t["scale1"], t["bias1"], t["res1"])
    gelu_args = (x2, t["scale2"], t["bias2"], None, "gelu_tanh")
    return [
        ("res+LN kernel", lambda: fused_layernorm(*res_args), n1),
        ("res+LN plain", lambda: fused_layernorm_reference(*res_args), n1),
        ("LN+GELU kernel", lambda: fused_layernorm(*gelu_args), n2),
        ("LN+GELU plain", lambda: fused_layernorm_reference(*gelu_args), n2),
        ("copy kernel", lambda: copy_rows(x2.view(-1, x2.shape[-1])), n2),
    ]


def time_call(fn: Callable, device: torch.device, iters: int, warmup: int = 3) -> float:
    """Mean ms of one call: CUDA events on the GPU, host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def run_probe(device: Union[str, torch.device] = "cuda", iters: int = 100,
              shapes: Optional[Dict[str, Tuple[int, ...]]] = None) -> List[dict]:
    """Times every probe case; returns one dict per line."""
    dev = resolve_device(device)
    cases = probe_cases(probe_inputs(shapes or SHAPES, dev))
    rows = []
    for name, fn, nbytes in cases:
        with torch.no_grad():
            ms = time_call(fn, dev, iters)
        rows.append(dict(name=name, ms=ms, bytes=nbytes, gb_per_s=nbytes / (ms * 1e-3) / 1e9,
                         device=str(dev)))
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=100)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    for row in run_probe(args.device, args.iters):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
