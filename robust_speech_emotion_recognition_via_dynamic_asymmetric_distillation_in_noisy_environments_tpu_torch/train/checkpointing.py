"""Full-train-state checkpointing for mid-run resume.

The reference persists only its best weights. Here the whole state
(student + teacher, Adam's moments and count, the learning rate, the DACP
state) and the trainer's random generator go into one ``torch.save`` file
of plain dicts of CPU tensors, with the loop's metadata (epoch, best
metrics, patience, anchors, history) in a JSON sidecar, as the JAX package
keeps it. The file resumes the port only; the best ``.pth`` is the format
the two packages share.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch

from ..utils import dump_json, load_json


def _plain(x: Any) -> Any:
    """NamedTuples -> dicts of their fields, tensors -> CPU tensors."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {f: _plain(v) for f, v in zip(x._fields, x)}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return x


def _restore(like: Any, saved: Any) -> Any:
    """``saved`` (from ``_plain``) in the structure, devices and dtypes of
    ``like``."""
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_restore(v, saved[f]) for f, v in zip(like._fields, like)))
    if isinstance(like, dict):
        if set(like) != set(saved):
            raise ValueError(f"checkpoint keys {sorted(saved)} != state keys {sorted(like)}")
        return {k: _restore(v, saved[k]) for k, v in like.items()}
    if isinstance(like, torch.Tensor):
        return saved.to(device=like.device, dtype=like.dtype)
    return saved


def save_train_state(path: str, state: Any, generator: Optional[torch.Generator] = None,
                     metadata: Optional[Dict] = None) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"state": _plain(state),
                "generator": None if generator is None else generator.get_state()}, path)
    if metadata is not None:
        dump_json(metadata, path + ".meta.json")


def restore_train_state(path: str, like: Any, generator: Optional[torch.Generator] = None
                        ) -> Tuple[Any, Optional[Dict]]:
    """Restores into the structure of ``like`` (a freshly initialised state)
    and, where both the file and the caller have one, the generator."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    state = _restore(like, saved["state"])
    if generator is not None and saved["generator"] is not None:
        generator.set_state(saved["generator"])
    meta_path = path + ".meta.json"
    meta = load_json(meta_path) if os.path.exists(meta_path) else None
    return state, meta
