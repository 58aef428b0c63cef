#!/usr/bin/env python3
"""Where the tensor-core conv kernel's time goes, on one NVIDIA GPU.

    python3 tools/conv_breakdown.py

Builds ``csrc/conv.cu`` of the PyTorch port four times: as it is, without
the B (weight) reloads (each ring stage keeps the B tile of its first
use), without the LN + GELU epilogue, and without both. The variants are
patched copies written under ``csrc/build/`` (gitignored); their output
is wrong by design and only timed. Each variant runs emotion2vec's conv
layers 1-5 at B = 64 clips of 4 s (bf16, erf GELU, random inputs) and is
timed in turns (each variant, then each in reverse) as device ms with cold
L2 (``utils/timing.py``). Prints the card's name and power limit, then one
JSON line per layer. Needs CUDA and nvcc; raises without them.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.ops import (  # noqa: E402
    conv,
    cuda_build,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.utils import (  # noqa: E402
    timing,
)

# text of conv.cu -> its replacement in a variant
NO_B_RELOAD = (
    "        mbar_expect_tx(&full[st], STAGE);\n",
    "        const bool with_b = use == 0;  // a stage keeps its first B tile\n"
    "        mbar_expect_tx(&full[st], with_b ? STAGE : A_BYTES);\n",
), (
    "        for (int n = 0; n < C_OUT / 64; ++n)\n",
    "        for (int n = 0; with_b && n < C_OUT / 64; ++n)\n",
)
NO_EPILOGUE = (
    "    tc_epilogue<N, APPROX>(acc,",
    "    if (acc[0] == 12345.f) out[threadIdx.x] = __float2bfloat16(acc[1]);  // keeps acc live\n"
    "    if (false) tc_epilogue<N, APPROX>(acc,",
),
VARIANTS = {
    "full": (),
    "no_b_reload": NO_B_RELOAD,
    "no_epilogue": NO_EPILOGUE,
    "no_b_reload_no_epilogue": NO_B_RELOAD + NO_EPILOGUE,
}
# (L, k) of emotion2vec's conv layers 1-5 at 4 s: 512 -> 512 channels, s = 2
LAYERS = ((12799, 3), (6399, 3), (3199, 3), (1599, 3), (799, 2))
B = 64


def build_variants() -> dict:
    """Patched copies of conv.cu, built in parallel; name -> CDLL."""
    source = (cuda_build.CSRC / "conv.cu").read_text()
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: conv.cu no longer has {old!r} once")
            text = text.replace(old, new)
        src = cuda_build.BUILD_DIR / f"conv_{name}.cu"
        src.write_text(text)
        lib = cuda_build.BUILD_DIR / f"libconv_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} variant:\n{out}")
        lib = ctypes.CDLL(str(path))
        lib.conv_ln_gelu_tc.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
                                        + [ctypes.c_void_p])
        lib.conv_ln_gelu_tc.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("conv_breakdown: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    libs = build_variants()
    gen = torch.Generator(device="cuda").manual_seed(0)
    order = list(VARIANTS) + list(reversed(VARIANTS))
    for L, k in LAYERS:
        x = torch.randn(B, L, 512, generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.randn(k, 512, 512, generator=gen, device="cuda") * 0.03).to(torch.bfloat16)
        scale, bias = torch.ones(512, device="cuda"), torch.zeros(512, device="cuda")
        plan = conv.conv_plan(B, L, 512, 512, k, 2, torch.bfloat16,
                              sms=torch.cuda.get_device_properties(0).multi_processor_count)
        out_bytes = B * plan.t_out * 512 * 2
        sets = [x] + [x.roll(n, dims=0)
                      for n in range(1, timing.rotation(x.numel() * 2 + out_bytes))]
        turns = {name: [] for name in VARIANTS}
        with torch.no_grad():
            for name in order:
                conv._library = lambda lib=libs[name]: lib  # launch_plan's library
                calls = [lambda xs=xs: conv.launch_plan(xs, w, scale, bias, k, 2, False, plan)
                         for xs in sets]
                turns[name].append(timing.device_ms(calls, cold=True, launches=8))
        print("breakdown: " + json.dumps(dict(
            L=L, k=k, t_out=plan.t_out, **{f"{n}_ms": sum(t) / 2 for n, t in turns.items()},
            turns=turns)), flush=True)
        del x, sets
    return 0


if __name__ == "__main__":
    sys.exit(main())
