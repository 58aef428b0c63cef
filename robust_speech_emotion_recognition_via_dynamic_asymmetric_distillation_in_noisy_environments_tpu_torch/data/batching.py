"""Bucketed batching of a feature store.

Every batch is padded up to one of a small fixed set of length buckets, and
its batch dimension up to the full batch size, with ``row_valid`` marking
the real rows. A few shapes cover a whole run. ``padding_mask`` keeps the
reference's True = pad meaning.

The visit order comes from numpy ``default_rng((seed, epoch))``, so the
batches here are the JAX package's, bit for bit, on either of its assembly
paths (numpy or its native batcher).
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from .store import FeatureStore


class Batch(NamedTuple):
    """A feature batch: numpy arrays on the host, tensors after the
    transfer (``data/prefetch.py``)."""

    feats: np.ndarray  # (B, T, D) float32
    padding_mask: np.ndarray  # (B, T) bool, True = padded frame
    labels: np.ndarray  # (B,) int32, -1 where absent/invalid
    ids: Optional[np.ndarray]  # (B,) int32 clip indices into the source store
    row_valid: np.ndarray  # (B,) bool, False = padded row


def pad_to_bucket(length: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if length <= b:
            return b
    # beyond the largest bucket: round up to a multiple of it
    top = buckets[-1]
    return int(np.ceil(length / top) * top)


def epoch_order(
    num: int,
    *,
    shuffle: bool,
    seed: int,
    epoch: int,
    bucket_shuffle: bool = False,
    sizes: Optional[np.ndarray] = None,
    buckets: Optional[Sequence[int]] = None,
    batch_size: Optional[int] = None,
    max_frames: Optional[int] = None,
) -> np.ndarray:
    """The clip visit order for one epoch.

    ``bucket_shuffle=False`` is the reference-shaped stream: a uniform
    (seed, epoch) permutation, every batch padded to its own longest clip's
    bucket.

    ``bucket_shuffle=True`` (opt-in, a deviation from the reference's batch
    composition): the same per-epoch draw, regrouped so that batches are
    bucket-homogeneous. Full batches are cut within each padded-length
    bucket in draw order, the per-bucket remainders are concatenated in
    bucket order into the last batches, and whole batches are then
    shuffled. The clips, the batch count and the short last batch are
    unchanged; only which clips share a batch moves.
    """
    order = np.arange(num)
    if not shuffle:
        return order
    rng = np.random.default_rng((seed, epoch))
    rng.shuffle(order)
    if not bucket_shuffle or num == 0:
        return order
    if sizes is None or buckets is None or batch_size is None:
        raise ValueError("bucket_shuffle needs sizes, buckets and batch_size")
    eff = np.asarray(sizes)[order]
    if max_frames is not None:
        eff = np.minimum(eff, max_frames)
    snap = {s: pad_to_bucket(int(s), buckets) for s in np.unique(eff)}
    padded = np.array([snap[s] for s in eff])
    B = int(batch_size)
    full: list = []
    rems: list = []
    for b in sorted(set(padded.tolist())):
        g = order[padded == b]  # draw order within the bucket
        n_full = len(g) // B * B
        full.extend(g[i : i + B] for i in range(0, n_full, B))
        if n_full < len(g):
            rems.append(g[n_full:])
    rest = np.concatenate(rems) if rems else np.empty(0, dtype=order.dtype)
    tail = [rest[i : i + B] for i in range(0, len(rest), B)]
    # the one short batch (num % B) must stay last so consecutive-B slicing
    # reproduces these exact batches; all full batches shuffle freely
    short = [b for b in tail if len(b) < B]
    batches = full + [b for b in tail if len(b) == B]
    perm = rng.permutation(len(batches))
    batches = [batches[i] for i in perm] + short
    return np.concatenate(batches) if batches else order


class PaddedBatchIterator:
    """Deterministic, restartable batch iterator over a FeatureStore.

    shuffle=True reshuffles each epoch from (seed, epoch); eval iterators keep
    store order. The last partial batch is padded (never dropped), as the
    reference's drop_last=False DataLoaders do.
    """

    def __init__(
        self,
        store: FeatureStore,
        batch_size: int,
        buckets: Sequence[int] = (64, 128, 256, 512, 1024, 2048),
        shuffle: bool = False,
        seed: int = 0,
        max_frames: Optional[int] = None,
        bucket_shuffle: bool = False,
    ):
        self.store = store
        self.batch_size = int(batch_size)
        self.buckets = tuple(buckets)
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.max_frames = max_frames
        self.bucket_shuffle = bucket_shuffle

    def __len__(self) -> int:
        return int(np.ceil(self.store.num / self.batch_size))

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _order(self) -> np.ndarray:
        return epoch_order(
            self.store.num,
            shuffle=self.shuffle,
            seed=self.seed,
            epoch=self.epoch,
            bucket_shuffle=self.bucket_shuffle,
            sizes=self.store.sizes,
            buckets=self.buckets,
            batch_size=self.batch_size,
            max_frames=self.max_frames,
        )

    def __iter__(self) -> Iterator[Batch]:
        order = self._order()
        B = self.batch_size
        dim = self.store.dim
        labels = self.store.labels
        for start in range(0, len(order), B):
            idx = order[start : start + B]
            sizes = self.store.sizes[idx]
            t_max = int(sizes.max()) if len(sizes) else 1
            if self.max_frames is not None:
                t_max = min(t_max, self.max_frames)
            T = pad_to_bucket(t_max, self.buckets)

            feats = np.zeros((B, T, dim), dtype=np.float32)
            padding_mask = np.ones((B, T), dtype=bool)
            out_labels = np.full((B,), -1, dtype=np.int32)
            ids = np.full((B,), -1, dtype=np.int32)
            row_valid = np.zeros((B,), dtype=bool)

            for row, clip_idx in enumerate(idx):
                clip = self.store.clip(int(clip_idx))[:T]
                n = len(clip)
                feats[row, :n] = clip
                padding_mask[row, :n] = False
                if labels is not None:
                    out_labels[row] = labels[int(clip_idx)]
                ids[row] = int(clip_idx)
                row_valid[row] = True

            # bucket rounding can pad T past the cap: frames beyond it read
            # as padding (the reference's max-length truncation)
            if self.max_frames is not None and T > self.max_frames:
                feats[:, self.max_frames:] = 0.0
                padding_mask[:, self.max_frames:] = True
            yield Batch(feats, padding_mask, out_labels, ids, row_valid)


def paired_epoch(
    clean_it: PaddedBatchIterator,
    noisy_it: PaddedBatchIterator,
    epoch: int,
) -> Iterator[Tuple[Batch, Batch]]:
    """Zips the clean and noisy train streams for one epoch, truncating to the
    shorter one (the reference's max_batches = min(len, len))."""
    clean_it.set_epoch(epoch)
    noisy_it.set_epoch(epoch)
    n = min(len(clean_it), len(noisy_it))
    ci, ni = iter(clean_it), iter(noisy_it)
    for _ in range(n):
        yield next(ci), next(ni)
