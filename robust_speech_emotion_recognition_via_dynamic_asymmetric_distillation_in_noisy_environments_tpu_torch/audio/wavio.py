"""Minimal wav IO on the stdlib ``wave`` module (no soundfile dependency).

Handles 8/16/24/32-bit integer PCM plus 32/64-bit IEEE float, mono or
multi-channel, returning float64 in [-1, 1] like soundfile does for the
reference scripts. The stdlib ``wave`` module rejects non-PCM format tags
(IEEE float = 3, WAVE_FORMAT_EXTENSIBLE = 0xFFFE) at open time, so those
fall back to a small RIFF chunk walker.
"""

from __future__ import annotations

import struct
import wave
from typing import Tuple

import numpy as np


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Returns (audio float64 in [-1,1], sample_rate). Multi-channel audio
    comes back as (frames, channels)."""
    try:
        with wave.open(path, "rb") as w:
            sr = w.getframerate()
            n_channels = w.getnchannels()
            sampwidth = w.getsampwidth()
            frames = w.readframes(w.getnframes())
        fmt_tag = 1
    except wave.Error:
        # stdlib wave raises "unknown format: 3" for IEEE-float files (and
        # for extensible-format headers) before sampwidth is readable
        frames, sr, n_channels, sampwidth, fmt_tag = _read_wav_riff(path)
    data = _decode_samples(frames, sampwidth, fmt_tag, path)
    if n_channels > 1:
        data = data.reshape(-1, n_channels)
    return data, sr


def _decode_samples(frames: bytes, sampwidth: int, fmt_tag: int,
                    path: str) -> np.ndarray:
    if fmt_tag == 3:  # IEEE float
        if sampwidth == 4:
            return np.frombuffer(frames, dtype="<f4").astype(np.float64)
        if sampwidth == 8:
            return np.frombuffer(frames, dtype="<f8").astype(np.float64)
        raise ValueError(f"{path}: unsupported float width {sampwidth}")
    if sampwidth == 1:
        # WAV stores 8-bit PCM UNSIGNED with a 128 offset (silence = 0x80)
        data = np.frombuffer(frames, dtype=np.uint8).astype(np.float64) - 128.0
        return data / 128.0
    if sampwidth == 2:
        data = np.frombuffer(frames, dtype="<i2").astype(np.float64)
    elif sampwidth == 3:
        # 24-bit little-endian: assemble int32 and sign-extend
        b = np.frombuffer(frames, dtype=np.uint8).reshape(-1, 3).astype(np.int32)
        x = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        data = np.where(x & 0x800000, x - (1 << 24), x).astype(np.float64)
    elif sampwidth == 4:
        data = np.frombuffer(frames, dtype="<i4").astype(np.float64)
    else:
        raise ValueError(f"{path}: unsupported PCM width {sampwidth}")
    return data / float(2 ** (8 * sampwidth - 1))


def _read_wav_riff(path: str):
    """Fallback RIFF parser for format tags the stdlib rejects (float,
    extensible). Returns (data bytes, sr, channels, sampwidth, fmt_tag)."""
    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < 12 or buf[:4] != b"RIFF" or buf[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    fmt = data = None
    pos = 12
    while pos + 8 <= len(buf):
        cid = buf[pos:pos + 4]
        (size,) = struct.unpack_from("<I", buf, pos + 4)
        body = buf[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt = body
        elif cid == b"data":
            data = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned
    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    tag, n_channels, sr = struct.unpack_from("<HHI", fmt, 0)
    (bits,) = struct.unpack_from("<H", fmt, 14)
    if tag == 0xFFFE and len(fmt) >= 26:
        # WAVE_FORMAT_EXTENSIBLE: the real tag leads the SubFormat GUID
        (tag,) = struct.unpack_from("<H", fmt, 24)
    return data, sr, n_channels, max(1, bits // 8), tag


def write_wav(path: str, audio: np.ndarray, sr: int) -> None:
    """Writes 16-bit PCM (the format the corpora use)."""
    audio = np.asarray(audio)
    if audio.ndim == 2:
        n_channels = audio.shape[1]
        flat = audio.reshape(-1)
    else:
        n_channels = 1
        flat = audio
    clipped = np.clip(flat, -1.0, 1.0)
    pcm = (clipped * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(n_channels)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def read_mono(path: str, sample_rate: int = 16000) -> np.ndarray:
    """read_wav -> mono-mix -> sample-rate gate -> float32.

    The one decode path of the wav store (``data/wavstore.py``): a store
    read from a manifest and one read from a packed directory hold the same
    samples only if every loader decodes through here."""
    audio, sr = read_wav(path)
    if audio.ndim == 2:
        audio = audio.mean(axis=1)
    if sr != sample_rate:
        raise ValueError(f"{path}: sample rate {sr} != {sample_rate} "
                         "(run the audio format fixer first)")
    return audio.astype(np.float32)
