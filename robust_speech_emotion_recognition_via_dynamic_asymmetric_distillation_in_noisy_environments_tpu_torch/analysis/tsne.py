"""Embedding-space t-SNE comparison (reference iemocap_plot_tsne.py).

Embeds a feature store through (a) a pretrain head and (b) a DAD student
encoder (``DADHead.embed`` on the caller's device), runs t-SNE on the host,
and reports silhouette / Calinski-Harabasz scores plus a side-by-side
scatter. The t-SNE and the scores are scikit-learn's: without it,
``analyze_tsne`` raises ImportError.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping

import numpy as np
import torch

from ..configs import DADConfig
from ..data.batching import PaddedBatchIterator
from ..data.prefetch import prefetch
from ..data.store import FeatureStore
from ..models.heads import DADHead
from ..utils import dump_json, resolve_device
from .common import get_pyplot, savefig


def make_embedder(cfg: DADConfig, params: Mapping[str, torch.Tensor], device="cuda") -> DADHead:
    """A ``DADHead`` on ``device`` holding ``params`` (a ``DADHead`` state
    dict, e.g. an ``SSRLState``'s student)."""
    dev = resolve_device(device)
    with torch.device("meta"):
        head = DADHead(cfg.input_dim, cfg.hidden_dim, cfg.num_classes, cfg.dropout_rate)
    head.to_empty(device=dev).load_state_dict({k: v.to(dev) for k, v in params.items()})
    return head


@torch.no_grad()
def embed_all(head: DADHead, it: PaddedBatchIterator, device="cuda"):
    """(X (N, hidden) f32, y (N,)) over the labelled valid rows of ``it``,
    in its order; the embeddings are read back once."""
    dev = resolve_device(device)
    embs, labels, valid = [], [], []
    for b in prefetch(it, depth=2, to_device=True, device=dev):
        embs.append(head.embed(b.feats, b.padding_mask))
        labels.append(b.labels)
        valid.append(b.row_valid)
    if not embs:
        return np.zeros((0, 1)), np.zeros(0, np.int64)
    y = torch.cat(labels).cpu().numpy()
    keep = torch.cat(valid).cpu().numpy() & (y >= 0)
    return torch.cat(embs).cpu().numpy()[keep], y[keep].astype(np.int64)


def analyze_tsne(
    cfg: DADConfig,
    store: FeatureStore,
    param_sets: Dict[str, Mapping[str, torch.Tensor]],  # {"pretrain": ..., "dad": ...}
    out_dir: str,
    perplexity: float = 30.0,
    seed: int = 42,
    device="cuda",
) -> Dict:
    try:
        from sklearn.manifold import TSNE
        from sklearn.metrics import calinski_harabasz_score, silhouette_score
    except ImportError as e:
        raise ImportError("analyze --kind tsne needs scikit-learn (the sklearn package), "
                          "which is not installed") from e

    it = PaddedBatchIterator(store, cfg.batch_size, cfg.length_buckets)
    summary: Dict = {}
    embeds = {}
    for name, params in param_sets.items():
        X, y = embed_all(make_embedder(cfg, params, device), it, device)
        if len(X) < 5:
            continue
        perp = min(perplexity, max(2, len(X) // 4))
        Z = TSNE(
            n_components=2, perplexity=perp, random_state=seed, init="pca"
        ).fit_transform(X)
        embeds[name] = (Z, y)
        summary[name] = {
            "silhouette": float(silhouette_score(X, y)) if len(set(y)) > 1 else None,
            "calinski_harabasz": float(calinski_harabasz_score(X, y))
            if len(set(y)) > 1
            else None,
            "num_samples": int(len(X)),
        }

    plt = get_pyplot()
    if plt and embeds:
        fig, axes = plt.subplots(1, len(embeds), figsize=(6 * len(embeds), 5))
        if len(embeds) == 1:
            axes = [axes]
        for ax, (name, (Z, y)) in zip(axes, embeds.items()):
            for c in range(cfg.num_classes):
                sel = y == c
                ax.scatter(Z[sel, 0], Z[sel, 1], s=8, alpha=0.6,
                           label=cfg.class_names[c])
            ax.set_title(f"{name} (sil={summary[name]['silhouette']:.3f})"
                         if summary[name]["silhouette"] is not None else name)
            ax.legend(fontsize=8)
        savefig(fig, out_dir, "tsne.png")
        plt.close(fig)

    dump_json(summary, os.path.join(out_dir, "tsne_summary.json"))
    return summary
