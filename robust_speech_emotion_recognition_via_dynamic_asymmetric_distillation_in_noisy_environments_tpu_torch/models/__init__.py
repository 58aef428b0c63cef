from .emotion2vec import Emotion2vecEncoder, extract_features, normalize_wav
from .extract import FeatureExtractor
from .heads import (
    DADClassifier,
    DADEncoder,
    DADHead,
    PretrainHead,
    SSRLState,
    ema_update,
    init_ssrl,
    load_pretrain_into_ssrl,
)

__all__ = [
    "Emotion2vecEncoder",
    "extract_features",
    "normalize_wav",
    "FeatureExtractor",
    "DADClassifier",
    "DADEncoder",
    "DADHead",
    "PretrainHead",
    "SSRLState",
    "ema_update",
    "init_ssrl",
    "load_pretrain_into_ssrl",
]
