from .serving import FRAME_BUCKETS, EmotionPredictor, PredictionServer

__all__ = ["FRAME_BUCKETS", "EmotionPredictor", "PredictionServer"]
