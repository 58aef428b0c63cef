from .metrics import (
    accuracy,
    balanced_accuracy,
    classification_report_text,
    confusion_matrix,
    evaluate_domain,
    f1_scores,
    precision_recall_fscore_support,
)
from .reports import (
    best_detailed_results,
    final_test_report,
    save_confusion_matrices,
)
from .inference import CrossDomainInference, detect_dataset_type
from .serving import FRAME_BUCKETS, EmotionPredictor, PredictionServer

__all__ = [
    "accuracy",
    "balanced_accuracy",
    "confusion_matrix",
    "f1_scores",
    "precision_recall_fscore_support",
    "evaluate_domain",
    "classification_report_text",
    "best_detailed_results",
    "final_test_report",
    "save_confusion_matrices",
    "CrossDomainInference",
    "detect_dataset_type",
    "FRAME_BUCKETS",
    "EmotionPredictor",
    "PredictionServer",
]
