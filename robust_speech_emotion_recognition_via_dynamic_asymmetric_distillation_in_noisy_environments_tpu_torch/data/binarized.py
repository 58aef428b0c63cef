"""Packed raw-audio stores for d2v pretraining (``cli d2v-pack``, then
``d2v-pretrain --binarized``), in the JAX package's format:

- ``pack_manifest`` decodes every wav of ``<split>.tsv`` once into one
  ``<split>.bin`` of mono float32 samples and a ``<split>.idx.npz`` index
  (per-clip ``lengths``, the tsv's ``manifest_frames`` verbatim,
  ``sample_rate``, ``version``), and copies the ``.emo``/``.lbl``/``.spk``
  sidecars, so that the directory is also a wav store
  (``data/wavstore.py::is_packed_dir`` is the one test for it).
- ``BinarizedWavDataset`` is ``WavCropDataset`` reading clips from an
  ``np.memmap`` of the ``.bin``: the same epochs, shuffles, crops and
  normalisation, so its batches equal those of the manifests it was packed
  from.
"""

from __future__ import annotations

import os
import shutil
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..audio.wavio import read_mono
from ..train.d2v_pretrain import WavCropDataset
from ..utils import get_logger
from .manifests import read_manifest
from .wavstore import is_packed_dir

logger = get_logger(__name__)

_FORMAT_VERSION = 1

__all__ = ["BinarizedWavDataset", "is_packed_dir", "pack_manifest"]


def pack_manifest(manifest_dir: str, out_dir: str, split: str = "train",
                  sample_rate: int = 16_000) -> Tuple[int, int]:
    """Packs ``<manifest_dir>/<split>.tsv``'s wavs into ``out_dir``.
    Returns (n_clips, total_samples)."""
    root, files = read_manifest(manifest_dir, split)
    os.makedirs(out_dir, exist_ok=True)
    bin_path = os.path.join(out_dir, f"{split}.bin")
    lengths: List[int] = []
    manifest_frames: List[int] = []
    with open(bin_path, "wb") as out:
        for rel, frames in files:
            clip = np.ascontiguousarray(read_mono(os.path.join(root, rel), sample_rate))
            out.write(clip.tobytes())
            lengths.append(len(clip))
            manifest_frames.append(int(frames))
    np.savez(
        os.path.join(out_dir, f"{split}.idx.npz"),
        lengths=np.asarray(lengths, np.int64),
        # the min_sample_size filter keys off the tsv's frames, as the wav
        # dataset's does
        manifest_frames=np.asarray(manifest_frames, np.int64),
        sample_rate=np.int64(sample_rate),
        version=np.int64(_FORMAT_VERSION),
    )
    for ext in (".emo", ".lbl", ".spk"):
        src = os.path.join(manifest_dir, split + ext)
        if os.path.exists(src):
            shutil.copy2(src, os.path.join(out_dir, split + ext))
    total = int(sum(lengths))
    logger.info("packed %d clips (%d samples, %.1f MB) -> %s", len(lengths), total,
                total * 4 / 1e6, bin_path)
    return len(lengths), total


class BinarizedWavDataset(WavCropDataset):
    """``WavCropDataset`` over packed stores; several mix with the same
    fractional ``weights``. Epochs keep clips by the packed manifest frames
    (frames < 0: kept), as the wav dataset keeps them."""

    def __init__(self, packed_dirs: Sequence[str], pcfg, split: str = "train",
                 weights: Optional[Sequence[float]] = None):
        self.pcfg = pcfg
        self.base_lists = []
        self._mmaps = []
        self._offsets = []
        for di, d in enumerate(packed_dirs):
            idx_path = os.path.join(d, f"{split}.idx.npz")
            if not os.path.exists(idx_path):
                raise FileNotFoundError(
                    f"{idx_path} not found — run `cli d2v-pack` first "
                    "(or pass a wav manifest dir without --binarized)")
            idx = np.load(idx_path)
            sr = int(idx["sample_rate"])
            if sr != pcfg.sample_rate:
                raise ValueError(f"{d}: packed at {sr} Hz != task {pcfg.sample_rate}")
            lengths = idx["lengths"].astype(np.int64)
            frames = (idx["manifest_frames"].astype(np.int64) if "manifest_frames" in idx
                      else lengths)
            offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]])
            mm = np.memmap(os.path.join(d, f"{split}.bin"), np.float32, mode="r")
            if mm.shape[0] != int(lengths.sum()):
                raise ValueError(f"{d}/{split}.bin size {mm.shape[0]} != index total "
                                 f"{int(lengths.sum())} (re-pack the store)")
            self._mmaps.append(mm)
            self._offsets.append(offsets)
            kept = [((di, ci), int(lengths[ci])) for ci, f in enumerate(frames)
                    if f < 0 or f >= pcfg.min_sample_size]
            if len(lengths) > len(kept):
                logger.info("%s: skipped %d clips under min_sample_size=%d",
                            d, len(lengths) - len(kept), pcfg.min_sample_size)
            self.base_lists.append(kept)
        self._init_weights(weights)

    def _load_audio(self, entry) -> np.ndarray:
        (di, ci), n = entry
        off = int(self._offsets[di][ci])
        return np.asarray(self._mmaps[di][off : off + n], np.float32)
