"""Speaker/session-isolated K-fold policies as pure functions.

- IEMOCAP: 5-fold session rotation table (reference data.py:39-61).
- CASIA: 4-fold speaker isolation, val = next speaker ring-wise
  (reference dataload_casia_clean.py:84-102). fold is 0-based.
- EMODB: 10-fold LOSO over the fixed speaker list, val = next speaker
  (reference dataload_emodb_clean.py:18-47). fold is 0-based.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

EMODB_SPEAKERS = ["03", "08", "09", "10", "11", "12", "13", "14", "15", "16"]

_IEMOCAP_FOLDS = {
    1: ([1, 2, 3], 4, 5),
    2: ([2, 3, 4], 5, 1),
    3: ([3, 4, 5], 1, 2),
    4: ([4, 5, 1], 2, 3),
    5: ([5, 1, 2], 3, 4),
}


def iemocap_fold_sessions(fold_id: int) -> Tuple[List[int], int, int]:
    """fold_id is 1-based (1..5), matching the reference convention."""
    if fold_id < 1 or fold_id > 5:
        raise ValueError(f"fold_id must be between 1 and 5, got {fold_id}")
    return _IEMOCAP_FOLDS[fold_id]


def casia_fold_speakers(
    fold: int, all_speakers: Sequence[str]
) -> Tuple[List[str], str, str]:
    """fold is 0-based (0..3). all_speakers must be the sorted unique list."""
    speakers = list(all_speakers)
    if len(speakers) != 4:
        raise ValueError(f"expected 4 CASIA speakers, got {len(speakers)}")
    test = speakers[fold]
    val = speakers[(fold + 1) % 4]
    train = [s for s in speakers if s not in (test, val)]
    return train, val, test


def emodb_fold_speakers(fold_id: int) -> Tuple[List[str], str, str]:
    """fold_id is 0-based (0..9)."""
    if fold_id < 0 or fold_id >= 10:
        raise ValueError(f"fold_id must be between 0 and 9, got {fold_id}")
    test = EMODB_SPEAKERS[fold_id]
    val = EMODB_SPEAKERS[(fold_id + 1) % 10]
    train = [s for s in EMODB_SPEAKERS if s not in (test, val)]
    return train, val, test


def split_indices(
    groups: np.ndarray,
    train_groups: Sequence,
    val_group,
    test_group,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Index split by group membership (reference data.py:226-228)."""
    groups = np.asarray(groups)
    train_idx = np.where(np.isin(groups, np.asarray(list(train_groups))))[0]
    val_idx = np.where(groups == val_group)[0]
    test_idx = np.where(groups == test_group)[0]
    return train_idx, val_idx, test_idx


def corpus_fold_split(
    corpus: str, fold: int, groups: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Unified entry: `fold` is 0-based for every corpus (IEMOCAP fold 0 maps
    to the reference's fold_id=1)."""
    if corpus == "iemocap":
        train_g, val_g, test_g = iemocap_fold_sessions(fold + 1)
    elif corpus == "casia":
        uniq = np.unique(groups)
        train_g, val_g, test_g = casia_fold_speakers(fold, list(uniq))
    elif corpus == "emodb":
        # sidecars may carry 'emodb_spk_03' (manifest format) or bare '03'
        groups = np.asarray([str(g)[-2:] for g in groups])
        train_g, val_g, test_g = emodb_fold_speakers(fold)
    else:
        raise KeyError(f"unknown corpus {corpus!r}")
    return split_indices(groups, train_g, val_g, test_g)
