"""Cross-corpus inference (reference DAD inference.py:70-615).

Loads a DAD checkpoint (the reference's torch .pth layout, as ``dad``
writes it), detects the test set's format from its sidecar files (``.emo``
=> IEMOCAP-style sessions, ``.lbl`` + ``.spk`` => CASIA/EMODB-style
speakers, inference.py:208-224), runs the student (or teacher) head over
the requested split on ``device`` and writes the metric suite with JSON and
PNG artifacts to a timestamped directory. The head is two small GEMMs,
left to ``torch.matmul``.
"""

from __future__ import annotations

import argparse
import os
from datetime import datetime
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..configs import DADConfig, dad_preset
from ..dad import make_eval_step
from ..data.batching import PaddedBatchIterator
from ..data.folds import corpus_fold_split
from ..data.store import load_feature_store
from ..models.convert import load_torch_file, torch_state_dict_to_ssrl
from ..models.heads import DADHead
from ..utils import dump_json, get_logger, resolve_device
from .metrics import evaluate_domain
from .reports import save_per_class_bars, save_single_confusion

logger = get_logger(__name__)


def detect_dataset_type(feature_dir: str, split: str = "train") -> str:
    if os.path.exists(os.path.join(feature_dir, f"{split}.emo")):
        return "iemocap"
    if os.path.exists(os.path.join(feature_dir, f"{split}.lbl")):
        return "speaker"  # CASIA/EMODB style
    raise FileNotFoundError(f"no label sidecar found in {feature_dir}")


class CrossDomainInference:
    def __init__(
        self,
        weight_path: str,
        test_data_dir: str,
        output_dir: str = "inference_results",
        cfg: Optional[DADConfig] = None,
        fold: int = 0,
        use_teacher: bool = False,
        device: Union[str, torch.device] = "cuda",
    ):
        self.device = resolve_device(device)
        self.weight_path = weight_path
        self.test_data_dir = test_data_dir
        self.fold = fold
        self.use_teacher = use_teacher

        ds_type = detect_dataset_type(test_data_dir)
        if cfg is None:
            # the label map follows the sidecar style; CASIA/EMODB share labels
            cfg = dad_preset("iemocap" if ds_type == "iemocap" else "casia")
        self.cfg = cfg
        self.ds_type = ds_type

        ts = datetime.now().strftime("%Y%m%d_%H%M%S")
        self.output_dir = os.path.join(output_dir, f"inference_{ts}")
        os.makedirs(self.output_dir, exist_ok=True)

        with torch.device(self.device):
            self.head = DADHead(cfg.input_dim, cfg.hidden_dim, cfg.num_classes,
                                cfg.dropout_rate)
        self.ssrl = torch_state_dict_to_ssrl(load_torch_file(weight_path))
        self.eval_step = make_eval_step(self.head)
        logger.info("loaded %s; test data %s detected as %s", weight_path, test_data_dir,
                    ds_type)

    def _loader(self, split_policy: str) -> PaddedBatchIterator:
        store = load_feature_store(self.test_data_dir, self.cfg.label_map)
        if split_policy == "all":
            subset = store
        else:
            if store.groups is None:
                raise ValueError(
                    f"{self.test_data_dir} has no speaker/session sidecar, so a fold "
                    "split cannot be derived: use --split all")
            if self.ds_type == "iemocap":
                corpus = "iemocap"
            else:
                # .lbl/.spk stores: the speaker-name prefix (casia_spk_* /
                # emodb_spk_* from the manifest builders) names the corpus;
                # the 4-speaker census is only a last resort
                g0 = str(store.groups[0]) if len(store.groups) else ""
                if g0.startswith("casia"):
                    corpus = "casia"
                elif g0.startswith("emodb"):
                    corpus = "emodb"
                else:
                    n_spk = len(np.unique(store.groups))
                    corpus = "casia" if n_spk == 4 else "emodb"
                    logger.warning(
                        "speaker names don't identify the corpus; guessed %r from %d unique "
                        "speakers: the fold policy may be wrong (use --split all for "
                        "cross-corpus evaluation)", corpus, n_spk)
            _tr, _va, te = corpus_fold_split(corpus, self.fold, store.groups)
            subset = store.subset(te)
        return PaddedBatchIterator(subset, self.cfg.batch_size, self.cfg.length_buckets,
                                   shuffle=False)

    def run_inference(self, split_policy: str = "test") -> Dict:
        """split_policy: 'test' = the fold's test split; 'all' = every clip
        (the cross-corpus evaluation mode)."""
        it = self._loader(split_policy)
        params = {k: v.to(self.device)
                  for k, v in (self.ssrl.teacher if self.use_teacher
                               else self.ssrl.student).items()}
        y_true, y_pred, confidences = [], [], []
        for b in it:
            preds, logits = self.eval_step(
                params, torch.from_numpy(b.feats).to(self.device),
                torch.from_numpy(b.padding_mask).to(self.device))
            probs = torch.softmax(logits, dim=-1).cpu().numpy()
            preds = preds.cpu().numpy()
            for i in range(len(preds)):
                if b.row_valid[i] and b.labels[i] >= 0:
                    y_true.append(int(b.labels[i]))
                    y_pred.append(int(preds[i]))
                    confidences.append(float(probs[i].max()))

        results = evaluate_domain(y_true, y_pred, self.cfg.num_classes)
        confidences = np.asarray(confidences)
        summary = {
            "info": {
                "weight_path": self.weight_path,
                "test_data_dir": self.test_data_dir,
                "dataset_type": self.ds_type,
                "split_policy": split_policy,
                "network": "teacher" if self.use_teacher else "student",
                "num_samples": len(y_true),
                "timestamp": datetime.now().isoformat(),
            },
            "metrics": {
                "accuracy": results["accuracy"],
                "weighted_accuracy": results["weighted_accuracy"],
                "f1_weighted": results["f1_weighted"],
                "f1_macro": results["f1_macro"],
                "precision_per_class": results["precision_per_class"],
                "recall_per_class": results["recall_per_class"],
                "f1_per_class": results["f1_per_class"],
                "support_per_class": results["support_per_class"],
                "confusion_matrix": results["confusion_matrix"].tolist(),
            },
            "confidence_stats": {
                "mean": float(confidences.mean()) if len(confidences) else 0.0,
                "std": float(confidences.std()) if len(confidences) else 0.0,
                "min": float(confidences.min()) if len(confidences) else 0.0,
                "max": float(confidences.max()) if len(confidences) else 0.0,
            },
            "class_names": list(self.cfg.class_names),
        }
        dump_json(summary, os.path.join(self.output_dir, "inference_results.json"))
        save_per_class_bars(self.output_dir, results, self.cfg.class_names)
        save_single_confusion(self.output_dir, results, self.cfg.class_names,
                              f"Inference ({os.path.basename(self.test_data_dir)})")
        logger.info("inference done: acc %.2f%% WA %.2f%% (n=%d)", results["accuracy"],
                    results["weighted_accuracy"], len(y_true))
        return summary


def add_infer_args(p: argparse.ArgumentParser) -> None:
    """The flags of ``infer``, shared with the package's ``cli infer``."""
    p.add_argument("--weights", required=True, help="DAD .pth (student_*/teacher_*)")
    p.add_argument("--test-data", required=True, help="feature store dir")
    p.add_argument("--output-dir", default="inference_results")
    p.add_argument("--fold", type=int, default=0)
    p.add_argument("--split", choices=["test", "all"], default="test")
    p.add_argument("--teacher", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; without a GPU, cuda fails")


def run(args) -> int:
    """``infer`` from parsed flags."""
    inf = CrossDomainInference(args.weights, args.test_data, args.output_dir, fold=args.fold,
                               use_teacher=args.teacher, device=args.device)
    inf.run_inference(args.split)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="cross-corpus DAD inference")
    add_infer_args(p)
    return run(p.parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
