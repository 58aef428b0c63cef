"""In-memory waveform store and bucketed wav batching for the fused
wav->train trainer.

The wav-level counterpart of ``data/store.py`` + ``data/batching.py``: one
flat float32 sample array with per-clip offsets (IEMOCAP's 4-class corpus
is about 1.6 GB as f32, so it is read once and kept in RAM), the feature
store's label and group sidecars, and a ``PaddedBatchIterator``-shaped
iterator whose batches snap to wav length buckets.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence

import numpy as np

from ..audio.wavio import read_mono
from ..utils import get_logger
from .batching import epoch_order, pad_to_bucket
from .manifests import read_manifest
from .store import read_label_sidecars

logger = get_logger(__name__)

# sample buckets of 1-30 s at 16 kHz (the extraction buckets of
# models/extract.py)
WAV_BUCKETS = (16000, 32000, 64000, 128000, 256000, 480000)


class WavBatch(NamedTuple):
    wav: np.ndarray  # (B, T) float32
    wav_mask: np.ndarray  # (B, T) bool, True = padded sample
    labels: np.ndarray  # (B,) int32, -1 where absent/invalid
    ids: np.ndarray  # (B,) int32 clip indices into the source store
    row_valid: np.ndarray  # (B,) bool, False = padded row


@dataclass
class WavStore:
    samples: np.ndarray  # flat (total_samples,) float32
    sizes: np.ndarray  # (N,) int64
    offsets: np.ndarray  # (N,) int64
    labels: Optional[np.ndarray] = None  # (N,) int32
    groups: Optional[np.ndarray] = None
    label_names: Optional[List[str]] = None
    utt_names: Optional[List[str]] = None

    @property
    def num(self) -> int:
        return len(self.sizes)

    def clip(self, i: int) -> np.ndarray:
        o = int(self.offsets[i])
        return self.samples[o : o + int(self.sizes[i])]

    def clips(self) -> List[np.ndarray]:
        return [self.clip(i) for i in range(self.num)]

    def subset(self, indices: Sequence[int]) -> "WavStore":
        """A view over the selected clips (the same flat array)."""
        indices = np.asarray(indices)
        return WavStore(
            samples=self.samples,
            sizes=self.sizes[indices],
            offsets=self.offsets[indices],
            labels=None if self.labels is None else self.labels[indices],
            groups=None if self.groups is None else self.groups[indices],
            label_names=None
            if self.label_names is None
            else [self.label_names[int(i)] for i in indices],
            utt_names=None
            if self.utt_names is None
            else [self.utt_names[int(i)] for i in indices],
        )


def is_packed_dir(d: str, split: str = "train") -> bool:
    """A directory written by the JAX package's ``cli d2v-pack``: one
    ``<split>.bin`` of float32 samples and its ``<split>.idx.npz``."""
    return os.path.exists(os.path.join(d, f"{split}.idx.npz"))


def load_wav_store(
    manifest_dir: str,
    label_map: Optional[Dict[str, int]] = None,
    split: str = "train",
) -> WavStore:
    """Reads every wav of a manifest into one flat RAM array, with labels
    and fold groups from the standard sidecars.

    Also reads a packed directory (``is_packed_dir``): its contiguous
    float32 ``.bin`` is this store's flat layout, so one file read replaces
    the decode loop (the sidecars are packed beside it)."""
    raw_labels, utt_names, raw_groups = read_label_sidecars(manifest_dir, split)

    if is_packed_dir(manifest_dir, split):
        idx = np.load(os.path.join(manifest_dir, f"{split}.idx.npz"))
        sr = int(idx["sample_rate"])
        if sr != 16000:
            raise ValueError(f"{manifest_dir}: packed at {sr} Hz != 16000")
        sizes = idx["lengths"].astype(np.int64)
        samples = np.fromfile(os.path.join(manifest_dir, f"{split}.bin"), np.float32)
        if samples.shape[0] != int(sizes.sum()):
            raise ValueError(
                f"{manifest_dir}/{split}.bin size {samples.shape[0]} != "
                f"index total {int(sizes.sum())} (re-pack the store)"
            )
        n_clips = len(sizes)
    else:
        root, files = read_manifest(manifest_dir, split)
        clips = [read_mono(os.path.join(root, rel)) for rel, _frames in files]
        sizes = np.asarray([len(c) for c in clips], np.int64)
        samples = np.concatenate(clips) if clips else np.zeros(0, np.float32)
        n_clips = len(clips)
    if raw_labels is not None and len(raw_labels) != n_clips:
        raise ValueError(f"{manifest_dir}: {len(raw_labels)} labels != {n_clips} clips")
    if raw_groups is not None and len(raw_groups) != n_clips:
        # a short .spk would shift every later clip's speaker, breaking fold
        # isolation without any error
        raise ValueError(f"{manifest_dir}: {len(raw_groups)} speakers != {n_clips} clips")

    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    labels = None
    if raw_labels is not None and label_map is not None:
        labels = np.asarray([label_map[x] for x in raw_labels], np.int32)
    store = WavStore(
        samples=samples,
        sizes=sizes,
        offsets=offsets,
        labels=labels,
        groups=None if raw_groups is None else np.asarray(raw_groups),
        label_names=raw_labels,
        utt_names=utt_names,
    )
    logger.info("loaded %d wavs (%.1f min audio) from %s", store.num,
                sizes.sum() / 16000 / 60, manifest_dir)
    return store


class PaddedWavIterator:
    """Bucket-snapped batches over a WavStore with ``PaddedBatchIterator``'s
    contract: (seed, epoch) shuffles, the last partial batch padded with
    row_valid=False, ids = the store's clip indices."""

    def __init__(
        self,
        store: WavStore,
        batch_size: int,
        buckets: Sequence[int] = WAV_BUCKETS,
        shuffle: bool = False,
        seed: int = 0,
        labeled: bool = True,
        bucket_shuffle: bool = False,
    ):
        self.store = store
        self.batch_size = int(batch_size)
        self.buckets = tuple(buckets)
        self.shuffle = shuffle
        self.seed = seed
        self.labeled = labeled
        self.epoch = 0
        self.bucket_shuffle = bucket_shuffle

    def __len__(self) -> int:
        return int(np.ceil(self.store.num / self.batch_size))

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[WavBatch]:
        order = epoch_order(
            self.store.num,
            shuffle=self.shuffle,
            seed=self.seed,
            epoch=self.epoch,
            bucket_shuffle=self.bucket_shuffle,
            sizes=self.store.sizes,
            buckets=self.buckets,
            batch_size=self.batch_size,
        )
        B = self.batch_size
        labels = self.store.labels if self.labeled else None
        for start in range(0, len(order), B):
            idx = order[start : start + B]
            t_max = int(self.store.sizes[idx].max()) if len(idx) else 1
            T = pad_to_bucket(t_max, self.buckets)
            wav = np.zeros((B, T), np.float32)
            mask = np.ones((B, T), bool)
            out_labels = np.full((B,), -1, np.int32)
            ids = np.full((B,), -1, np.int32)
            row_valid = np.zeros((B,), bool)
            for row, ci in enumerate(idx):
                c = self.store.clip(int(ci))
                wav[row, : len(c)] = c
                mask[row, : len(c)] = False
                if labels is not None:
                    out_labels[row] = labels[int(ci)]
                ids[row] = int(ci)
                row_valid[row] = True
            yield WavBatch(wav, mask, out_labels, ids, row_valid)
