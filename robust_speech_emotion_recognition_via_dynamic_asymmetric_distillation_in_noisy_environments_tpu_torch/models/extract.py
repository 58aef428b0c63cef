"""Batched feature extraction: length-bucketed padded batches through the
encoder. The padding-exact batched forward (``layers.PositionalConv``)
gives the same features as per-clip extraction. Ported so far:
``FeatureExtractor.extract_clips`` (the serving path and the fused
trainer's startup); ``extract_manifest`` comes with ``cli extract``.
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..configs import EncoderConfig
from ..utils import get_logger, resolve_device
from .emotion2vec import Emotion2vecEncoder, normalize_wav
from .layers import conv_out_lengths

logger = get_logger(__name__)


def _bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; past the top, the next multiple of the top."""
    for b in buckets:
        if n <= b:
            return b
    top = buckets[-1]
    return int(np.ceil(n / top) * top)


class FeatureExtractor:
    """Batched emotion2vec feature extractor on one device."""

    def __init__(
        self,
        cfg: EncoderConfig,
        state_dict: Mapping[str, torch.Tensor],
        batch_size: int = 16,
        buckets: Sequence[int] = (16000, 32000, 64000, 128000, 256000, 480000),
        device: Union[str, torch.device] = "cuda",
    ):
        """``state_dict``: the port's encoder layout, from
        ``convert.fairseq_to_torch_encoder`` or ``flax_encoder_to_torch``."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.batch_size = batch_size
        self.buckets = tuple(buckets)
        with torch.device(self.device):
            self.model = Emotion2vecEncoder(cfg)
        self.model.load_state_dict(state_dict)
        self.model.eval().requires_grad_(False)

    @torch.no_grad()
    def forward_batch(
        self, wav: torch.Tensor, wav_mask: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, T) waveform + mask on the device -> f32 features, frame mask."""
        x = normalize_wav(wav, wav_mask) if self.cfg.normalize_input else wav
        feats, frame_mask = self.model(x, wav_mask)
        return feats.float(), frame_mask

    def extract_clips(self, clips: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Extracts features for a list of 1-D waveforms, preserving order."""
        order = np.argsort([len(c) for c in clips], kind="stable")
        results: List[Optional[np.ndarray]] = [None] * len(clips)
        B = self.batch_size
        for start in range(0, len(order), B):
            idx = order[start : start + B]
            group = [clips[i] for i in idx]
            T = _bucket(max(len(c) for c in group), self.buckets)
            wav = np.zeros((B, T), np.float32)
            mask = np.ones((B, T), bool)
            for row, c in enumerate(group):
                wav[row, : len(c)] = c
                mask[row, : len(c)] = False
            feats, _ = self.forward_batch(
                torch.from_numpy(wav).to(self.device),
                torch.from_numpy(mask).to(self.device),
            )
            feats = feats.cpu().numpy()
            out_lens = conv_out_lengths(
                torch.tensor([len(c) for c in group]), self.cfg.conv_feature_layers
            ).numpy()
            for row, i in enumerate(idx):
                results[int(i)] = feats[row, : out_lens[row]]
        return results  # type: ignore[return-value]
