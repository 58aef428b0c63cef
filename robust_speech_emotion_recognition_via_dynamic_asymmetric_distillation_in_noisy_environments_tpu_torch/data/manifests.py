"""Wav manifests in the reference's on-disk format: ``train.tsv`` whose
first line is the corpus root and whose other lines are
``relpath\\tframes``, plus the label sidecars (``train.emo`` for IEMOCAP,
``train.lbl``/``train.spk`` for CASIA and EMODB). Reference scripts:
iemocap_manifest.py:32-70, casia_manifest.py:7-52, emodb_manifest.py:8-39.

The corpus builders (``build_*_manifest``, ``parse_*``) back ``cli
manifest``; ``fix_manifest_paths`` repairs a manifest after its wav tree
moves.
"""

from __future__ import annotations

import os
import re
import wave
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..utils import get_logger

logger = get_logger(__name__)

# --- CASIA speaker alias normalization (casia_manifest.py:7-19) ---
CASIA_SPEAKER_MAP = {
    "liuchanhg": "casia_spk_1",
    "wangzhe": "casia_spk_2",
    "zhaoquanyin": "casia_spk_3",
    "ZhaoZuoxiang": "casia_spk_4",
    "Chang.Liu": "casia_spk_1",
    "Zhe.Wang": "casia_spk_2",
    "Quanyin.Zhao": "casia_spk_3",
    "Zuoxiang.Zhao": "casia_spk_4",
}

# normal -> neutral (casia_manifest.py:25-30)
CASIA_EMOTION_MAP = {
    "angry": "angry",
    "happy": "happy",
    "sad": "sad",
    "neutral": "neutral",
    "normal": "neutral",
}

# EmoDB letter codes as the reference maps them (emodb_manifest.py:8-13).
# NB: this mapping (A->angry, T->happy, L->sad) follows the reference code,
# not the canonical EmoDB letter semantics.
EMODB_EMOTION_MAP = {"A": "angry", "T": "happy", "L": "sad", "N": "neutral"}

# IEMOCAP 4-class filter with excited folded into happy
# (complete_preprocessing.ps1:61-63)
IEMOCAP_EMOTION_MAP = {
    "ang": "ang",
    "exc": "hap",
    "hap": "hap",
    "neu": "neu",
    "sad": "sad",
}

_EMODB_NAME_RE = re.compile(r"(\d+)([ab])(\d+)([A-Z])([a-z])")


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


def fix_manifest_paths(
    manifest_dir: str, new_root: str, split: str = "train"
) -> int:
    """Repairs manifest path references after a wav tree moves/reshapes
    (reference CASIA scripts/fix_manifest_paths.py:12-31): rewrites the root
    line and drops entries whose files no longer resolve."""
    root, files = read_manifest(manifest_dir, split)
    kept = []
    by_basename: Optional[Dict[str, str]] = None
    for rel, frames in files:
        cand = os.path.join(new_root, rel)
        if os.path.exists(cand):
            kept.append((rel, frames))
        else:
            # flat->hierarchical repair by basename; index the tree ONCE
            # on first miss (a reshaped corpus misses on most entries, and
            # a full walk per entry is O(entries x tree))
            if by_basename is None:
                by_basename = {}
                for dirpath, _d, fnames in os.walk(new_root):
                    for fname in fnames:
                        by_basename.setdefault(
                            fname,
                            os.path.relpath(
                                os.path.join(dirpath, fname), new_root
                            ),
                        )
            hit = by_basename.get(os.path.basename(rel))
            if hit is not None:
                kept.append((hit.replace("\\", "/"), frames))
            else:
                logger.warning("dropping unresolvable manifest entry %s", rel)
    with open(os.path.join(manifest_dir, f"{split}.tsv"), "w", encoding="utf-8") as f:
        print(new_root, file=f)
        for rel, frames in kept:
            print(rel, frames, sep="\t", file=f)
    return len(kept)


def parse_iemocap_emo_evaluation(eval_dir: str) -> Dict[str, str]:
    """Parses IEMOCAP ``EmoEvaluation/*.txt`` into {utt_name: 4-class label},
    keeping {ang, exc->hap, hap, neu, sad} (complete_preprocessing.ps1:42-90).

    Lines look like: ``[start - end]\tSes01F_impro01_F000\tneu\t[v, a, d]``.
    """
    labels: Dict[str, str] = {}
    line_re = re.compile(r"^\[[\d.\s-]+\]\t(\S+)\t(\w+)\t")
    for fname in sorted(os.listdir(eval_dir)):
        if not fname.endswith(".txt"):
            continue
        with open(os.path.join(eval_dir, fname), encoding="utf-8", errors="replace") as f:
            for line in f:
                m = line_re.match(line)
                if m:
                    utt, emo = m.group(1), m.group(2)
                    if emo in IEMOCAP_EMOTION_MAP:
                        labels[utt] = IEMOCAP_EMOTION_MAP[emo]
    return labels


def build_iemocap_manifest(
    root: str,
    dest: str,
    label_path: Optional[str] = None,
    labels: Optional[Dict[str, str]] = None,
) -> List[ManifestEntry]:
    """IEMOCAP: utterance names like ``Ses01F_impro01_F000``; wav lives at
    ``Session{N}/sentences/wav/<folder>/<utt>.wav`` (iemocap_manifest.py:41-58).
    """
    if labels is None:
        assert label_path is not None
        labels = {}
        with open(label_path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    name, lbl = line.split("\t")[:2]
                    labels[name.strip()] = lbl.strip()
    entries = []
    for utt, lbl in labels.items():
        session = utt[4]
        folder = utt.rsplit("_", 1)[0]
        full = os.path.join(
            root, f"Session{session}", "sentences", "wav", folder, utt + ".wav"
        )
        try:
            frames = wav_frames(full)
        except (OSError, wave.Error) as e:
            logger.warning("skipping %s: %s", full, e)
            continue
        entries.append(
            ManifestEntry(
                relpath=os.path.relpath(full, root),
                frames=frames,
                label=lbl,
                speaker=f"session_{session}",
                utt_name=utt,
            )
        )
    write_manifest(dest, root, entries, sidecar="emo")
    return entries


def build_casia_manifest(root: str, dest: str) -> List[ManifestEntry]:
    """CASIA layout: ``<speaker_alias>/<emotion>/<utt>.wav`` with the alias
    and emotion maps above (casia_manifest.py:43-80)."""
    entries = []
    for dirpath, _dirnames, filenames in sorted(os.walk(root)):
        for fname in sorted(filenames):
            if not fname.lower().endswith(".wav"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, fname), root)
            parts = rel.replace("\\", "/").split("/")
            if len(parts) < 3:
                continue
            spk_raw, emo_raw = parts[0], parts[1]
            speaker = CASIA_SPEAKER_MAP.get(spk_raw)
            emotion = CASIA_EMOTION_MAP.get(emo_raw.lower())
            if speaker is None or emotion is None:
                continue
            full = os.path.join(dirpath, fname)
            try:
                frames = wav_frames(full)
            except (OSError, wave.Error) as e:
                logger.warning("skipping %s: %s", full, e)
                continue
            entries.append(
                ManifestEntry(
                    relpath=rel,
                    frames=frames,
                    label=emotion,
                    speaker=speaker,
                    utt_name=os.path.splitext(fname)[0],
                )
            )
    write_manifest(dest, root, entries, sidecar="lbl")
    return entries


def parse_emodb_filename(filename: str):
    """``03a01Fa.wav`` -> (speaker, sentence_type, sentence_num, emotion,
    variant); emotion None if the letter code is outside the 4-class subset
    (emodb_manifest.py:19-39)."""
    base = filename.replace(".wav", "")
    m = _EMODB_NAME_RE.match(base)
    if not m:
        return None
    spk, stype, snum, code, variant = m.groups()
    return (f"emodb_spk_{spk}", stype, snum, EMODB_EMOTION_MAP.get(code), variant)


def build_emodb_manifest(root: str, dest: str) -> List[ManifestEntry]:
    entries = []
    for dirpath, _dirnames, filenames in sorted(os.walk(root)):
        for fname in sorted(filenames):
            if not fname.lower().endswith(".wav"):
                continue
            parsed = parse_emodb_filename(fname)
            if parsed is None or parsed[3] is None:
                continue
            speaker, _stype, _snum, emotion, _variant = parsed
            full = os.path.join(dirpath, fname)
            try:
                frames = wav_frames(full)
            except (OSError, wave.Error) as e:
                logger.warning("skipping %s: %s", full, e)
                continue
            entries.append(
                ManifestEntry(
                    relpath=os.path.relpath(full, root),
                    frames=frames,
                    label=emotion,
                    speaker=speaker,
                    utt_name=os.path.splitext(fname)[0],
                )
            )
    write_manifest(dest, root, entries, sidecar="lbl")
    return entries
