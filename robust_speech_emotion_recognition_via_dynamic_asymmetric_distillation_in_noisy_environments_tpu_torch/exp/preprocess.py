"""Grid preprocessing: the reference's PowerShell pipeline loops as
one command.

Reproduces noisy_preprocessing.ps1 / real_noise_preprocessing.ps1: for each
noise condition of the grid, inject noise over the manifest's wav tree into
a ``root1-{type}-{snr}db`` (or ``root2-{snr}db``) sibling tree, verify the
achieved SNR, and extract features into a matching feature directory. The
encoder is loaded once for the whole grid.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Sequence, Union

import torch

from ..audio.cli import inject
from ..utils import get_logger

logger = get_logger(__name__)


def write_noisy_manifest(manifest_dir: str, wav_root: str, dest: str,
                         split: str = "train") -> str:
    """A copy of ``manifest_dir``'s manifest (the same relpaths, frames and
    label sidecars) whose root line is ``wav_root``: the manifest of a
    noisy tree that ``inject`` wrote with the clean tree's layout."""
    os.makedirs(dest, exist_ok=True)
    with open(os.path.join(manifest_dir, f"{split}.tsv"), encoding="utf-8") as f:
        lines = f.read().split("\n")
    with open(os.path.join(dest, f"{split}.tsv"), "w", encoding="utf-8") as f:
        print(wav_root, file=f)
        for line in lines[1:]:
            if line.strip():
                print(line, file=f)
    for ext in (".emo", ".lbl", ".spk"):
        src = os.path.join(manifest_dir, split + ext)
        if os.path.exists(src):
            with open(src, encoding="utf-8") as fi, open(
                    os.path.join(dest, split + ext), "w", encoding="utf-8") as fo:
                fo.write(fi.read())
    return dest


def run_noise_grid(
    manifest_dir: str,
    clean_root: str,
    output_base: str,
    snrs: Sequence[float],
    noise_types: Optional[Sequence[str]] = None,  # None => white noise
    noise_root: Optional[str] = None,
    root2: bool = False,
    checkpoint: Optional[str] = None,
    features_base: Optional[str] = None,
    verify: bool = True,
    seed: int = 42,
    engine: str = "numpy",
    encoder_cfg=None,
    device: Union[str, torch.device] = "cuda",
) -> List[Dict]:
    """Returns one record per condition: {name, wav_dir, feature_dir}.

    ``encoder_cfg`` (EncoderConfig) configures the extraction encoder when a
    ``checkpoint`` is given; the default is the full-size emotion2vec config
    with attention through the kernel. Extraction runs on ``device``."""
    typed = [t for t in (noise_types or []) if t not in (None, "white")]
    if (typed or root2) and not noise_root:
        # without the NOISEX bank the injector would fall back to white
        # noise while the output trees carry the requested type names
        raise ValueError(
            "noise_root is required for typed noise conditions "
            f"({typed or 'root2'}); white-noise grids use noise_types=None"
        )

    enc_cfg = enc_state = None
    if checkpoint:
        # once for the whole grid (the reference's loop re-invokes the
        # extraction CLI per condition, re-reading the ~360 MB checkpoint)
        from ..configs import encoder_config
        from ..models.convert import load_emotion2vec_checkpoint

        enc_cfg = encoder_cfg or encoder_config()
        enc_state = load_emotion2vec_checkpoint(checkpoint, enc_cfg)

    if root2:
        conditions = [("root2", None, snr) for snr in snrs]
    elif noise_types:
        conditions = [("root1", ntype, snr) for ntype in noise_types for snr in snrs]
    else:
        conditions = [("root1", "white", snr) for snr in snrs]

    results = []
    for root_kind, ntype, snr in conditions:
        name = f"root2-{int(snr)}db" if root_kind == "root2" else f"root1-{ntype}-{int(snr)}db"
        out_root = os.path.join(output_base, name)
        logger.info("=== condition %s ===", name)
        args = argparse.Namespace(
            input_root=clean_root,
            output_root=out_root,
            snr_db=snr,
            manifest_path=os.path.join(manifest_dir, "train.tsv"),
            noise_root=noise_root if (ntype not in (None, "white")) or root2 else None,
            noise_mode="random" if root2 else "type_specific",
            noise_type=ntype or "babble",
            seed=seed,
            verify=verify,
            tolerance=2.0,
            engine=engine,
            threads=0,
        )
        rc = inject(args)
        if rc not in (0, 2):  # 2 = verification warning
            raise RuntimeError(f"injection failed for {name}")

        record = {"name": name, "wav_dir": out_root, "feature_dir": None}
        if checkpoint:
            from ..models.extract import extract_manifest

            noisy_manifest = write_noisy_manifest(
                manifest_dir, out_root, os.path.join(output_base, f"manifest-{name}"))
            feat_dir = os.path.join(features_base or output_base, f"features-{name}")
            extract_manifest(noisy_manifest, feat_dir, enc_cfg, enc_state, device=device)
            record["feature_dir"] = feat_dir
        results.append(record)
    return results
