"""Feature store: on-disk compatible with the reference's flat layout.

A feature directory holds ``train.npy`` (sum-of-lengths x 768 float32),
``train.lengths`` (one frame count per clip), and one of the label sidecars:

- ``train.emo``  IEMOCAP: ``<utt_name>\t<label>`` per line; session id is
  parsed from char 4 of the name (``Ses0X...``) — reference data.py:11-37.
  Plain one-token and space-separated two-token lines are also tolerated
  (reference data.py:84-89).
- ``train.lbl`` + ``train.spk``  CASIA/EMODB: one label / one speaker per
  line — reference dataload_casia_clean.py:40-48.

This module is pure numpy, the host-side half of the input pipeline, and
writes the same bytes as the JAX package's copy.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..utils import get_logger

logger = get_logger(__name__)


@dataclass
class FeatureStore:
    """In-memory image of a feature directory.

    ``feats`` stays flat (total_frames, dim); clips are addressed via
    (offset, size) pairs just like the reference keeps them, so subsetting
    is an index operation, not a copy, until batching time.
    """

    feats: np.ndarray  # (total_frames, dim) float32
    sizes: np.ndarray  # (num_clips,) int
    offsets: np.ndarray  # (num_clips,) int
    labels: Optional[np.ndarray] = None  # (num_clips,) int, or None
    # grouping key per clip used by the fold policy: IEMOCAP session ids
    # (ints 1..5) or speaker ids (strings)
    groups: Optional[np.ndarray] = None
    label_names: Optional[List[str]] = None  # raw string labels, pre-mapping
    utt_names: Optional[List[str]] = None
    # backing .npy file when loaded from disk — enables the native mmap path
    npy_path: Optional[str] = None

    @property
    def num(self) -> int:
        return len(self.sizes)

    @property
    def dim(self) -> int:
        return self.feats.shape[1]

    def clip(self, i: int) -> np.ndarray:
        o = int(self.offsets[i])
        return self.feats[o : o + int(self.sizes[i])]

    def subset(self, indices: Sequence[int]) -> "FeatureStore":
        """Zero-copy view over the selected clips: sizes/offsets are
        re-indexed against the SAME flat array. (The reference repacks into a
        contiguous copy, data.py:230-252 — numerically identical; a view
        keeps the mmap-backed native batcher usable and avoids the copy.)"""
        indices = np.asarray(indices)
        return FeatureStore(
            feats=self.feats,
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
            npy_path=self.npy_path,
        )

    def validate(self) -> bool:
        """Data-integrity check mirroring validate_emotion2vec_data
        (reference DAD utils.py:92-129). For a canonical on-disk store the
        lengths must exactly tile the feature rows; for a subset view, every
        (offset, size) span must stay in bounds."""
        rows = self.feats.shape[0]
        if self.num:
            ends = self.offsets + self.sizes
            if int(ends.max()) > rows or int(self.offsets.min()) < 0:
                logger.error("clip span out of bounds (rows=%d)", rows)
                return False
            contiguous = bool(
                self.offsets[0] == 0
                and np.all(self.offsets[1:] == np.cumsum(self.sizes)[:-1])
            )
            if contiguous and int(np.sum(self.sizes)) != rows:
                logger.error(
                    "length mismatch: sum(lengths)=%d vs feature rows=%d",
                    int(np.sum(self.sizes)),
                    rows,
                )
                return False
        if self.labels is not None and len(self.labels) != self.num:
            logger.error("label count mismatch")
            return False
        return True


def _parse_emo_line(line: str) -> tuple:
    """Returns (utt_name_or_None, label) for one .emo line, tolerating the
    three formats the reference accepts (data.py:84-89)."""
    if "\t" in line:
        name, lbl = line.split("\t", 1)
        return name.strip(), lbl.strip()
    parts = line.split()
    if len(parts) == 1:
        return None, parts[0]
    return parts[0], parts[1]


def read_label_sidecars(manifest_dir: str, split: str = "train"):
    """Parses the reference label/speaker sidecars next to a manifest or
    feature store: ``.emo`` (IEMOCAP; session group from 'Ses0X' char 4,
    reference data.py:31) or ``.lbl``/``.spk`` (CASIA/EMODB). Returns
    (raw_labels, utt_names, raw_groups) — the SINGLE parser shared by the
    feature store and the fused trainer's wav store."""
    prefix = os.path.join(manifest_dir, split)
    emo_path = prefix + ".emo"
    lbl_path = prefix + ".lbl"
    spk_path = prefix + ".spk"

    raw_labels: Optional[List[str]] = None
    utt_names: Optional[List[str]] = None
    raw_groups: Optional[List] = None

    if os.path.exists(emo_path):
        raw_labels, utt_names = [], []
        with open(emo_path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                name, lbl = _parse_emo_line(line)
                utt_names.append(name)
                raw_labels.append(lbl)
        # IEMOCAP session id = int of char 4 of 'Ses0X...' (data.py:31)
        raw_groups = [
            int(name[4]) if name and len(name) > 4 and name[4].isdigit() else -1
            for name in utt_names
        ]
    elif os.path.exists(lbl_path):
        with open(lbl_path, encoding="utf-8") as f:
            raw_labels = [line.strip() for line in f if line.strip()]
        if os.path.exists(spk_path):
            with open(spk_path, encoding="utf-8") as f:
                raw_groups = [line.strip() for line in f if line.strip()]
    return raw_labels, utt_names, raw_groups


def load_feature_store(
    feature_dir: str,
    label_map: Optional[Dict[str, int]] = None,
    split: str = "train",
    min_length: int = 1,
    max_length: Optional[int] = None,
) -> FeatureStore:
    """Loads a reference-format feature directory.

    Mirrors load_dataset/load_ssl_features (reference data.py:63-197) plus
    the CASIA/EMODB ``.lbl``/``.spk`` variants. Clips shorter than
    ``min_length`` (or longer than ``max_length``) are skipped, with offsets
    advanced past them just like the reference.
    """
    prefix = os.path.join(feature_dir, split)
    feats = np.load(prefix + ".npy")
    with open(prefix + ".lengths") as f:
        raw_lengths = [int(line.strip()) for line in f if line.strip()]
    if sum(raw_lengths) != feats.shape[0]:
        # reference validate_emotion2vec_data contract (DAD utils.py:114-122)
        raise ValueError(
            f"corrupt feature store {feature_dir}: sum(lengths)="
            f"{sum(raw_lengths)} != rows={feats.shape[0]}"
        )

    raw_labels, utt_names, raw_groups = read_label_sidecars(
        feature_dir, split
    )
    for name, seq in (("labels", raw_labels), ("speakers", raw_groups)):
        if seq is not None and len(seq) != len(raw_lengths):
            # a short sidecar would misalign every later clip's label or
            # speaker (breaking fold isolation) with no error
            raise ValueError(
                f"{feature_dir}: {len(seq)} {name} != "
                f"{len(raw_lengths)} clips"
            )

    sizes, offsets = [], []
    keep: List[int] = []
    offset = 0
    for i, length in enumerate(raw_lengths):
        if length >= min_length and (max_length is None or length <= max_length):
            sizes.append(length)
            offsets.append(offset)
            keep.append(i)
        offset += length

    def _filter(seq):
        return None if seq is None else [seq[i] for i in keep]

    raw_labels = _filter(raw_labels)
    utt_names = _filter(utt_names)
    raw_groups = _filter(raw_groups)

    labels = None
    if raw_labels is not None and label_map is not None:
        labels = np.array([label_map[x] for x in raw_labels], dtype=np.int32)

    store = FeatureStore(
        feats=feats,
        sizes=np.asarray(sizes, dtype=np.int64),
        offsets=np.asarray(offsets, dtype=np.int64),
        labels=labels,
        groups=None if raw_groups is None else np.asarray(raw_groups),
        label_names=raw_labels,
        utt_names=utt_names,
        npy_path=prefix + ".npy",
    )
    logger.info(
        "loaded %d clips (dim %d) from %s", store.num, store.dim, feature_dir
    )
    return store


def write_feature_store(
    feature_dir: str,
    clips: Sequence[np.ndarray],
    labels: Optional[Sequence[str]] = None,
    utt_names: Optional[Sequence[str]] = None,
    speakers: Optional[Sequence[str]] = None,
    split: str = "train",
    sidecar: str = "emo",
) -> None:
    """Writes a reference-format feature directory.

    ``sidecar='emo'`` emits ``<name>\t<label>`` lines (IEMOCAP style);
    ``sidecar='lbl'`` emits ``.lbl`` (+ ``.spk`` if speakers given).
    """
    os.makedirs(feature_dir, exist_ok=True)
    prefix = os.path.join(feature_dir, split)
    flat = (
        np.concatenate(clips, axis=0)
        if clips
        else np.zeros((0, 768), dtype=np.float32)
    )
    np.save(prefix + ".npy", flat.astype(np.float32))
    with open(prefix + ".lengths", "w") as f:
        for c in clips:
            print(len(c), file=f)
    if labels is not None:
        if sidecar == "emo":
            assert utt_names is not None
            with open(prefix + ".emo", "w", encoding="utf-8") as f:
                for name, lbl in zip(utt_names, labels):
                    print(f"{name}\t{lbl}", file=f)
        else:
            with open(prefix + ".lbl", "w", encoding="utf-8") as f:
                for lbl in labels:
                    print(lbl, file=f)
            if speakers is not None:
                with open(prefix + ".spk", "w", encoding="utf-8") as f:
                    for spk in speakers:
                        print(spk, file=f)
