"""Bandwidth probe of the fused-norm kernels (the counterpart of the JAX
package's ``tools/bench_fused_norm.py``, main and ``--extra``).

    python -m <this package>.ops.norm_probe [--iters 100]

At the two shapes the encoder's LayerNorms have in the fused step (B = 64
clips of 4 s), bf16, it times the kernels of ``ops/fused_norm.py`` beside
their plain versions and prints one line each with the effective rate:
- transformer block LN: (64, 199, 768), residual + affine LN;
- conv stack LN + GELU: (64, 3199, 512), affine LN + tanh-GELU;
- row copy of the latter shape: the bandwidth ceiling.

Runs on the GPU unless the caller passes ``device="cpu"``. On the GPU each
line carries the measures of ``utils/timing.py``: ``device_ms_cold`` (CUDA
graph replays over a rotation of input sets larger than L2; ``gb_per_s``
is computed from it), ``device_ms_warm`` (one input set), ``call_ms``
(events around eager calls, host launch cost included) and ``host_us`` (host
clock per call, no synchronisation). On the CPU a line carries only
``host_ms``, the host clock around synchronous calls: the CPU has no device
metric.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch

from ..utils import timing
from ..utils.device import resolve_device
from .fused_norm import copy_rows, fused_layernorm, fused_layernorm_reference

# (rows' leading shape, features) of the two probe shapes
SHAPES: Dict[str, Tuple[int, ...]] = {
    "res_ln": (64, 199, 768),
    "ln_gelu": (64, 3199, 512),
}


def probe_inputs(shapes: Dict[str, Tuple[int, ...]], device: torch.device,
                 seed: int = 0) -> Dict[str, torch.Tensor]:
    """Seeded bf16 activations and f32 affine parameters, drawn on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device=device).to(dtype)

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


def run_probe(device: Union[str, torch.device] = "cuda", iters: int = 100,
              shapes: Optional[Dict[str, Tuple[int, ...]]] = None) -> List[dict]:
    """Times every probe case; returns one dict per line."""
    dev = resolve_device(device)
    shapes = shapes or SHAPES
    first = probe_cases(probe_inputs(shapes, dev))
    sets = 1
    if dev.type == "cuda":  # enough input sets that the smallest case runs cold
        sets = timing.rotation(min(nbytes for _, _, nbytes in first))
    cases = [first] + [probe_cases(probe_inputs(shapes, dev, seed=k)) for k in range(1, sets)]
    rows = []
    for i, (name, _, nbytes) in enumerate(first):
        calls = [c[i][1] for c in cases]
        row = dict(name=name, bytes=nbytes, device=str(dev))
        with torch.no_grad():
            if dev.type != "cuda":
                row["host_ms"] = timing.host_seconds(calls[0], iters) * 1e3
            else:
                row.update(device_ms_cold=timing.device_ms(calls, cold=True),
                           device_ms_warm=timing.device_ms(calls[:1], cold=False),
                           call_ms=timing.call_ms(calls[0], iters),
                           host_us=timing.host_us(calls[0], iters))
                row["gb_per_s"] = nbytes / (row["device_ms_cold"] * 1e-3) / 1e9
        rows.append(row)
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
