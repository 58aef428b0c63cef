"""ctypes bridge to the native (C++) offline noise injector.

Runs the whole manifest's wav read -> SNR mix -> wav write loop across a
thread pool (``native/inject.cc``) instead of the serial Python loop in
``audio/cli.py``; the reference's scripts (add_noise_to_audio.py:110-146,
add_real_noise_to_audio.py:180-240) process a root1 grid (5 noise types x
4 SNRs x ~5.5k clips) one file at a time.

The numpy engine stays the reference-exact path (numpy PCG64 white-noise
draws); this engine is deterministic given the same seeds but draws white
noise with std::mt19937_64, so its outputs hit the SNR rather than the
numpy engine's samples. Real-noise mixing (a deterministic scale of a
noise clip) equals the numpy engine's up to float accumulation order.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, Optional, Sequence

import numpy as np

from ..data.native import c_ptr, native_available, native_lib
from ..utils import get_logger

logger = get_logger(__name__)


def native_inject_available() -> bool:
    """Whether the native library (batcher and injector) builds and loads."""
    return native_available()


def inject_files_native(
    in_paths: Sequence[str],
    out_paths: Sequence[str],
    snr_db: float,
    noise_bank: Optional[Dict[str, np.ndarray]] = None,
    noise_type_per_file: Optional[Sequence[str]] = None,
    seeds: Optional[np.ndarray] = None,
    n_threads: int = 0,
) -> np.ndarray:
    """Injects noise into every (in, out) pair; returns per-file status
    (0 ok, 1 read error, 2 write error).

    White mode: ``noise_bank is None``: per-file gaussian noise at the
    target SNR, seeded from ``seeds`` (default ``arange``).
    Real mode: ``noise_bank`` maps type name -> mono float array, and
    ``noise_type_per_file`` names each file's noise (type_specific passes a
    constant list; random mode passes the pre-drawn choices, so the engine
    stays deterministic).
    """
    lib = native_lib()
    n = len(in_paths)
    if len(out_paths) != n:
        raise ValueError("in_paths and out_paths length mismatch")
    in_arr = (ctypes.c_char_p * n)(*[p.encode() for p in in_paths])
    out_arr = (ctypes.c_char_p * n)(*[p.encode() for p in out_paths])
    statuses = np.zeros(n, dtype=np.int32)
    seeds = np.ascontiguousarray(
        np.arange(n, dtype=np.uint64) if seeds is None else seeds, dtype=np.uint64)

    bank = offsets = lens = idx = None
    if noise_bank is not None:
        if noise_type_per_file is None or len(noise_type_per_file) != n:
            raise ValueError("real mode needs noise_type_per_file per clip")
        names = sorted(noise_bank)
        arrs = [np.ascontiguousarray(noise_bank[nm], dtype=np.float32) for nm in names]
        lens = np.asarray([len(a) for a in arrs], dtype=np.int64)
        offsets = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
        bank = np.ascontiguousarray(np.concatenate(arrs), dtype=np.float32)
        pos = {nm: i for i, nm in enumerate(names)}
        idx = np.asarray([pos[t] for t in noise_type_per_file], dtype=np.int32)

    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 4, 16)
    # the arrays above stay referenced through the call
    failures = lib.inject_files(
        in_arr, out_arr, n, float(snr_db),
        None if bank is None else c_ptr(bank, ctypes.c_float),
        None if offsets is None else c_ptr(offsets, ctypes.c_int64),
        None if lens is None else c_ptr(lens, ctypes.c_int64),
        None if idx is None else c_ptr(idx, ctypes.c_int32),
        c_ptr(seeds, ctypes.c_uint64), c_ptr(statuses, ctypes.c_int32), n_threads)
    if failures:
        bad = [in_paths[i] for i in np.nonzero(statuses)[0][:5]]
        logger.warning("native injector: %d failures (first: %s)", failures, bad)
    return statuses
