"""Classification head and the teacher-student (SSRL) parameter holder.

- ``DADHead``: Linear 768->256 -> ReLU -> masked mean pool (``encoder``),
  then dropout + Linear 256->C (``classifier``). Its state dict keys
  (``encoder.pre_net.*``, ``classifier.fc_layer.*``) are the reference
  checkpoint's with the ``student_``/``teacher_`` prefix removed.
- ``SSRLState``: student and teacher ``DADHead`` state dicts.

Forward (inference) only: training-mode dropout, initialisation and the
EMA update wait for the training slice. Parameters start at zero and are
loaded from a checkpoint.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch
from torch import nn

from ..ops.masked import masked_mean_pool


def _linear(in_dim: int, out_dim: int) -> nn.Linear:
    """nn.Linear without its random init (weights come from a checkpoint)."""
    layer = nn.utils.skip_init(nn.Linear, in_dim, out_dim)
    nn.init.zeros_(layer.weight)
    nn.init.zeros_(layer.bias)
    return layer


class DADEncoder(nn.Module):
    """Linear 768->256 + ReLU + masked mean pool."""

    def __init__(self, input_dim: int = 768, hidden_dim: int = 256):
        super().__init__()
        self.pre_net = _linear(input_dim, hidden_dim)

    def forward(self, feats: torch.Tensor, padding_mask: torch.Tensor) -> torch.Tensor:
        return masked_mean_pool(torch.relu(self.pre_net(feats)), padding_mask)


class DADClassifier(nn.Module):
    """Dropout + Linear 256->C; inference runs without dropout."""

    def __init__(self, hidden_dim: int = 256, num_classes: int = 4,
                 dropout_rate: float = 0.1):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.fc_layer = _linear(hidden_dim, num_classes)

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        if not deterministic and self.dropout_rate > 0:
            raise NotImplementedError(
                "training-mode dropout is not ported to the PyTorch package yet"
            )
        return self.fc_layer(x)


class DADHead(nn.Module):
    """Encoder + classifier in one module; returns (logits, embeddings)."""

    def __init__(self, input_dim: int = 768, hidden_dim: int = 256,
                 num_classes: int = 4, dropout_rate: float = 0.1):
        super().__init__()
        self.encoder = DADEncoder(input_dim, hidden_dim)
        self.classifier = DADClassifier(hidden_dim, num_classes, dropout_rate)

    def forward(self, feats, padding_mask, deterministic: bool = True):
        emb = self.encoder(feats, padding_mask)
        return self.classifier(emb, deterministic=deterministic), emb


class SSRLState(NamedTuple):
    """Student/teacher ``DADHead`` state dicts."""

    student: Dict[str, torch.Tensor]
    teacher: Dict[str, torch.Tensor]
