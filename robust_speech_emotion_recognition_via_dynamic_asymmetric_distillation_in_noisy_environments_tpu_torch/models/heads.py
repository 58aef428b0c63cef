"""Classification heads and the teacher-student (SSRL) parameter holder.

- ``PretrainHead``: Linear 768->256 -> ReLU -> masked mean pool -> Linear
  256->C (checkpoint keys ``pre_net.*`` / ``post_net.*``), the supervised
  pretrain stage's model (``init_pretrain_head``).
- ``DADHead``: Linear 768->256 -> ReLU -> masked mean pool (``encoder``),
  then dropout + Linear 256->C (``classifier``). Its state dict keys
  (``encoder.pre_net.*``, ``classifier.fc_layer.*``) are the reference
  checkpoint's with the ``student_``/``teacher_`` prefix removed;
  ``embed`` gives the pooled embeddings alone.
- ``SSRLState``: student and teacher ``DADHead`` state dicts. The teacher
  follows the student by EMA (``ema_update``).

Modules are built without random init (parameters come from a checkpoint
or from ``init_ssrl``); random draws come from explicit generators.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..ops.masked import masked_mean_pool
from .layers import dropout


def _linear(in_dim: int, out_dim: int) -> nn.Linear:
    """nn.Linear without its random init."""
    layer = nn.utils.skip_init(nn.Linear, in_dim, out_dim)
    nn.init.zeros_(layer.weight)
    nn.init.zeros_(layer.bias)
    return layer


class PretrainHead(nn.Module):
    """Supervised pretrain head (reference checkpoint layout)."""

    def __init__(self, input_dim: int = 768, hidden_dim: int = 256, num_classes: int = 4):
        super().__init__()
        self.pre_net = _linear(input_dim, hidden_dim)
        self.post_net = _linear(hidden_dim, num_classes)

    def forward(self, feats: torch.Tensor, padding_mask: torch.Tensor) -> torch.Tensor:
        return self.post_net(masked_mean_pool(torch.relu(self.pre_net(feats)), padding_mask))


class DADEncoder(nn.Module):
    """Linear 768->256 + ReLU + masked mean pool."""

    def __init__(self, input_dim: int = 768, hidden_dim: int = 256):
        super().__init__()
        self.pre_net = _linear(input_dim, hidden_dim)

    def forward(self, feats: torch.Tensor, padding_mask: torch.Tensor) -> torch.Tensor:
        return masked_mean_pool(torch.relu(self.pre_net(feats)), padding_mask)


class DADClassifier(nn.Module):
    """Dropout + Linear 256->C. The teacher runs with ``deterministic=True``
    (no dropout); the student's dropout draws from ``generator``."""

    def __init__(self, hidden_dim: int = 256, num_classes: int = 4,
                 dropout_rate: float = 0.1):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.fc_layer = _linear(hidden_dim, num_classes)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not deterministic:
            x = dropout(x, self.dropout_rate, generator)
        return self.fc_layer(x)


class DADHead(nn.Module):
    """Encoder + classifier in one module; returns (logits, embeddings)."""

    def __init__(self, input_dim: int = 768, hidden_dim: int = 256,
                 num_classes: int = 4, dropout_rate: float = 0.1):
        super().__init__()
        self.encoder = DADEncoder(input_dim, hidden_dim)
        self.classifier = DADClassifier(hidden_dim, num_classes, dropout_rate)

    def forward(self, feats, padding_mask, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        emb = self.encoder(feats, padding_mask)
        return self.classifier(emb, deterministic=deterministic, generator=generator), emb

    def embed(self, feats: torch.Tensor, padding_mask: torch.Tensor) -> torch.Tensor:
        return self.encoder(feats, padding_mask)


class SSRLState(NamedTuple):
    """Student/teacher ``DADHead`` state dicts."""

    student: Dict[str, torch.Tensor]
    teacher: Dict[str, torch.Tensor]


def _clone(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in params.items()}


def _torch_linear_init(module: nn.Module, fan_in, generator: Optional[torch.Generator],
                       device) -> Dict[str, torch.Tensor]:
    """Every weight and bias of ``module`` (built on the meta device) drawn
    as torch ``nn.Linear`` draws them, U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    from ``generator`` in state-dict order; ``fan_in(name)`` gives a
    parameter's fan-in. ``module`` is materialised on ``device`` with them."""
    params = {}
    draw_on = None if generator is None else generator.device
    for name, p in module.state_dict().items():
        bound = 1.0 / math.sqrt(fan_in(name))
        u = torch.rand(p.shape, generator=generator, device=draw_on)
        params[name] = ((u * 2.0 - 1.0) * bound).to(device)
    module.to_empty(device=device or "cpu").load_state_dict(params)
    return params


def init_pretrain_head(
    generator: Optional[torch.Generator] = None,
    input_dim: int = 768,
    hidden_dim: int = 256,
    num_classes: int = 4,
    device=None,
) -> Tuple[PretrainHead, Dict[str, torch.Tensor]]:
    """A ``PretrainHead`` on ``device`` and its state dict, drawn as
    ``init_ssrl`` draws a ``DADHead`` (the same shapes in the same order)."""
    with torch.device("meta"):
        head = PretrainHead(input_dim, hidden_dim, num_classes)
    params = _torch_linear_init(
        head, lambda name: input_dim if name.startswith("pre_net.") else hidden_dim,
        generator, device)
    return head, params


def init_ssrl(
    generator: Optional[torch.Generator] = None,
    input_dim: int = 768,
    hidden_dim: int = 256,
    num_classes: int = 4,
    dropout_rate: float = 0.1,
    device=None,
) -> Tuple[DADHead, SSRLState]:
    """The ``DADHead`` module plus an ``SSRLState`` with teacher == student.

    Every weight and bias is drawn as torch ``nn.Linear`` draws them,
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), from ``generator`` in state-dict
    order, and lives on ``device``."""
    with torch.device("meta"):
        head = DADHead(input_dim, hidden_dim, num_classes, dropout_rate)
    student = _torch_linear_init(
        head, lambda name: input_dim if name.startswith("encoder.") else hidden_dim,
        generator, device)
    return head, SSRLState(student=student, teacher=_clone(student))


def ema_update(state: SSRLState, momentum: float) -> SSRLState:
    """teacher <- m * teacher + (1 - m) * student."""
    teacher = {k: t * momentum + state.student[k] * (1.0 - momentum)
               for k, t in state.teacher.items()}
    return SSRLState(student=state.student, teacher=teacher)


def load_pretrain_into_ssrl(state: SSRLState,
                            pretrain: Dict[str, torch.Tensor]) -> SSRLState:
    """A ``PretrainHead`` state dict into both student and teacher:
    pre_net -> encoder.pre_net, post_net -> classifier.fc_layer."""
    student = _clone(state.student)
    for src, dst in (("pre_net", "encoder.pre_net"), ("post_net", "classifier.fc_layer")):
        for leaf in ("weight", "bias"):
            old = student[f"{dst}.{leaf}"]
            student[f"{dst}.{leaf}"] = pretrain[f"{src}.{leaf}"].detach().to(
                device=old.device, dtype=old.dtype).clone()
    return SSRLState(student=student, teacher=_clone(student))
