"""Device selection for the entry points.

Entry points run on the GPU unless the caller asks for the CPU. Without a
GPU and without an explicit ``device="cpu"`` they raise: nothing carries on
on the CPU silently.
"""

from __future__ import annotations

from typing import Union

import torch

def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
