from .d2v_pretrain import (
    D2vPretrainModel,
    D2vTrainState,
    Decoder1d,
    encoder_params,
    init_d2v_state,
    make_d2v_train_step,
)
from .emotion2vec import Emotion2vecEncoder, extract_features, normalize_wav
from .extract import FeatureExtractor, extract_manifest
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
    "D2vPretrainModel",
    "D2vTrainState",
    "Decoder1d",
    "encoder_params",
    "init_d2v_state",
    "make_d2v_train_step",
    "Emotion2vecEncoder",
    "extract_features",
    "normalize_wav",
    "FeatureExtractor",
    "extract_manifest",
    "DADClassifier",
    "DADEncoder",
    "DADHead",
    "PretrainHead",
    "SSRLState",
    "ema_update",
    "init_ssrl",
    "load_pretrain_into_ssrl",
]
