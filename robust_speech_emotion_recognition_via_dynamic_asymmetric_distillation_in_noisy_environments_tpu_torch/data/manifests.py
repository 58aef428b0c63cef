"""Wav manifests in the reference's on-disk format: ``train.tsv`` whose
first line is the corpus root and whose other lines are
``relpath\\tframes``, plus the label sidecars (``train.emo`` for IEMOCAP,
``train.lbl``/``train.spk`` for CASIA and EMODB). Reference scripts:
iemocap_manifest.py:32-70, casia_manifest.py:7-52, emodb_manifest.py:8-39.

Ported so far: the reader and writer that the fused trainer's wav store
stands on. The corpus builders (``build_*_manifest``, ``parse_*``,
``fix_manifest_paths``) come with ``cli manifest``.
"""

from __future__ import annotations

import os
import wave
from dataclasses import dataclass
from typing import List, Tuple


def wav_frames(path: str) -> int:
    """Frame count of a wav file (stdlib; no soundfile dependency)."""
    with wave.open(path, "rb") as w:
        return w.getnframes()


@dataclass
class ManifestEntry:
    relpath: str
    frames: int
    label: str
    speaker: str
    utt_name: str


def write_manifest(
    dest: str,
    root: str,
    entries: List[ManifestEntry],
    sidecar: str,
    split: str = "train",
) -> None:
    os.makedirs(dest, exist_ok=True)
    with open(os.path.join(dest, f"{split}.tsv"), "w", encoding="utf-8") as f:
        print(root, file=f)
        for e in entries:
            print(e.relpath.replace("\\", "/"), e.frames, sep="\t", file=f)
    if sidecar == "emo":
        with open(os.path.join(dest, f"{split}.emo"), "w", encoding="utf-8") as f:
            for e in entries:
                print(f"{e.utt_name}\t{e.label}", file=f)
    else:
        with open(os.path.join(dest, f"{split}.lbl"), "w", encoding="utf-8") as f:
            for e in entries:
                print(e.label, file=f)
        with open(os.path.join(dest, f"{split}.spk"), "w", encoding="utf-8") as f:
            for e in entries:
                print(e.speaker, file=f)


def read_manifest(dest: str, split: str = "train") -> Tuple[str, List[Tuple[str, int]]]:
    with open(os.path.join(dest, f"{split}.tsv"), encoding="utf-8") as f:
        lines = [ln for ln in f.read().split("\n") if ln.strip()]
    root = lines[0].strip()
    files = []
    for line in lines[1:]:
        parts = line.split("\t")
        files.append((parts[0], int(parts[1]) if len(parts) > 1 else -1))
    return root, files
