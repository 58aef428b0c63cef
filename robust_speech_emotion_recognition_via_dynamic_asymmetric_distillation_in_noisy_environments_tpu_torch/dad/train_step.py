"""DAD step functions. Ported so far: the eval forward only; the training
step, optimizer and DACP updates come with the training slice."""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch.func import functional_call

from ..models.heads import DADHead


def make_eval_step(head: DADHead) -> Callable[..., Tuple[torch.Tensor, torch.Tensor]]:
    """Eval forward: returns (preds, logits) for a batch using either
    student or teacher params (a ``DADHead`` state dict)."""

    @torch.no_grad()
    def fwd(params: Dict[str, torch.Tensor], feats: torch.Tensor,
            padding_mask: torch.Tensor):
        logits, _ = functional_call(head, params, (feats, padding_mask))
        return torch.argmax(logits, dim=-1), logits

    return fwd
