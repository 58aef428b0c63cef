from .store import FeatureStore, load_feature_store, write_feature_store
from .folds import (
    iemocap_fold_sessions,
    casia_fold_speakers,
    emodb_fold_speakers,
    split_indices,
    corpus_fold_split,
    EMODB_SPEAKERS,
)
from .batching import Batch, PaddedBatchIterator, pad_to_bucket
from .prefetch import prefetch
from .manifests import ManifestEntry, read_manifest, wav_frames, write_manifest
from .native import NativeStore, native_available
from .wavstore import WAV_BUCKETS, PaddedWavIterator, WavBatch, WavStore, load_wav_store

__all__ = [
    "FeatureStore",
    "load_feature_store",
    "write_feature_store",
    "iemocap_fold_sessions",
    "casia_fold_speakers",
    "emodb_fold_speakers",
    "split_indices",
    "corpus_fold_split",
    "EMODB_SPEAKERS",
    "Batch",
    "PaddedBatchIterator",
    "pad_to_bucket",
    "prefetch",
    "ManifestEntry",
    "read_manifest",
    "wav_frames",
    "write_manifest",
    "NativeStore",
    "native_available",
    "WAV_BUCKETS",
    "PaddedWavIterator",
    "WavBatch",
    "WavStore",
    "load_wav_store",
]
