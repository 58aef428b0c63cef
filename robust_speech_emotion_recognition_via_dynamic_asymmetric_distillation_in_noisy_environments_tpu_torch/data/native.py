"""ctypes bridge to the native (C++) host library: the feature-store
batcher (``native/batcher.cc``) and the offline noise injector
(``native/inject.cc``), the repository's C++ sources.

The library is built at first use from those two sources with the flags of
``native/build.sh`` into ``csrc/build/`` (listed in ``.gitignore``), named
by a hash of the sources, the flags and the target that ``-march=native``
resolves to on this host, so neither a changed source nor a build tree
copied to another CPU loads a stale library. Processes that start together build it once: the build
holds an exclusive ``flock`` on a lock file beside the library and writes
to a temporary name that it ``os.replace``s, so another process either
waits for the lock or loads a whole file. A build that fails raises with
the compiler's output every time it is asked for: nothing falls back to
numpy and no failure is cached.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / "native"
SOURCES = ("batcher.cc", "inject.cc")
# the flags of native/build.sh
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread")
BUILD_DIR = Path(__file__).resolve().parent.parent / "csrc" / "build"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _compiler() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native host library cannot be built")
    return cxx


@functools.lru_cache(maxsize=None)
def _target(cxx: str) -> str:
    """The compiler's target options under ``-march=native`` on this host
    (the instruction sets the library is built for)."""
    res = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                         capture_output=True, text=True)
    return res.stdout


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_target(_compiler()).encode())
    for name in SOURCES:
        h.update((NATIVE_DIR / name).read_bytes())
    return BUILD_DIR / f"libdadtpu_native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compiles the library unless it exists; returns its path. Raises
    with the compiler's output when the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libdadtpu_native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if out.exists():  # built while this process waited
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_compiler(), *CXX_FLAGS, "-o", str(tmp), *(str(NATIVE_DIR / s) for s in SOURCES)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"building the native host library failed (exit "
                               f"{res.returncode}):\n{res.stdout}\n{res.stderr}")
        os.replace(tmp, out)
    return out


def _declare(lib: ctypes.CDLL) -> None:
    i64, i32, f32 = ctypes.c_int64, ctypes.c_int32, ctypes.c_float
    P = ctypes.POINTER
    lib.store_open.restype = i64
    lib.store_open.argtypes = [ctypes.c_char_p, i64, i64, i64, P(i64), P(i64), i64]
    lib.store_wrap.restype = i64
    lib.store_wrap.argtypes = [P(f32), i64, P(i64), P(i64), i64]
    lib.store_close.restype = None
    lib.store_close.argtypes = [i64]
    lib.batch_assemble.restype = ctypes.c_int
    lib.batch_assemble.argtypes = [i64, P(i64), i64, i64, P(i32), P(f32), P(ctypes.c_uint8),
                                   P(i32), P(ctypes.c_uint8), i32]
    lib.inject_files.restype = i64
    lib.inject_files.argtypes = [P(ctypes.c_char_p), P(ctypes.c_char_p), i64, ctypes.c_double,
                                 P(f32), P(i64), P(i64), P(i32), P(ctypes.c_uint64), P(i32),
                                 i32]


def native_lib() -> ctypes.CDLL:
    """The process's handle to the native library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the library builds and loads here. A failure is not
    remembered: the next call tries again."""
    try:
        native_lib()
    except (RuntimeError, OSError):
        return False
    return True


def npy_data_offset(path: str) -> int:
    """Byte offset of the data section in a .npy v1/v2 file."""
    with open(path, "rb") as f:
        if f.read(6) != b"\x93NUMPY":
            raise ValueError(f"not a npy file: {path}")
        major, _minor = f.read(1)[0], f.read(1)[0]
        if major == 1:
            (hlen,) = np.frombuffer(f.read(2), dtype="<u2")
            return 10 + int(hlen)
        (hlen,) = np.frombuffer(f.read(4), dtype="<u4")
        return 12 + int(hlen)


def c_ptr(a: np.ndarray, ctype):
    """A ctypes pointer to ``a``'s data; the caller keeps ``a`` alive."""
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class NativeStore:
    """C++ batch assembly over a float32 array in memory, or over a .npy
    file mapped by the C side (``from_file``)."""

    def __init__(self, feats: Optional[np.ndarray], sizes: np.ndarray, offsets: np.ndarray,
                 labels: Optional[np.ndarray], n_threads: int = 4,
                 npy_path: Optional[str] = None):
        self._lib = native_lib()
        self._handle = -1
        self.n_threads = n_threads
        self._sizes = np.ascontiguousarray(sizes, dtype=np.int64)
        self._offsets = np.ascontiguousarray(offsets, dtype=np.int64)
        self._labels = (None if labels is None
                        else np.ascontiguousarray(labels, dtype=np.int32))
        self.num = len(self._sizes)
        if npy_path is None:
            # the C side reads this buffer for the store's lifetime
            self._feats = np.ascontiguousarray(feats, dtype=np.float32)
            self.dim = int(self._feats.shape[1])
            self._handle = self._lib.store_wrap(
                c_ptr(self._feats, ctypes.c_float), self.dim, c_ptr(self._sizes, ctypes.c_int64),
                c_ptr(self._offsets, ctypes.c_int64), self.num)
        else:
            self._feats = None
            self.dim = int(feats.shape[1])
            self._handle = self._lib.store_open(
                npy_path.encode(), npy_data_offset(npy_path), int(self._sizes.sum()), self.dim,
                c_ptr(self._sizes, ctypes.c_int64), c_ptr(self._offsets, ctypes.c_int64),
                self.num)
        if self._handle < 0:
            raise RuntimeError(f"native store failed to open {npy_path or 'an array'}")

    @classmethod
    def from_file(cls, npy_path: str, sizes: np.ndarray, offsets: np.ndarray,
                  labels: Optional[np.ndarray], n_threads: int = 4) -> "NativeStore":
        """Maps the .npy itself (no copy of a large store)."""
        feats = np.load(npy_path, mmap_mode="r")
        if feats.dtype != np.float32:
            # the C side reads the raw bytes as float32
            raise ValueError(f"{npy_path}: native store needs float32, got {feats.dtype}")
        return cls(feats, sizes, offsets, labels, n_threads, npy_path=npy_path)

    def assemble(self, indices: np.ndarray, t_max: int):
        """(feats (B, t_max, D) f32, padding mask (B, t_max) True = pad,
        labels (B,) int32, row_valid (B,)) for clip ``indices``, -1 = a
        padded row."""
        B = len(indices)
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        feats = np.empty((B, t_max, self.dim), np.float32)
        mask = np.empty((B, t_max), np.uint8)
        labels = np.empty((B,), np.int32)
        valid = np.empty((B,), np.uint8)
        rc = self._lib.batch_assemble(
            self._handle, c_ptr(idx, ctypes.c_int64), B, t_max,
            None if self._labels is None else c_ptr(self._labels, ctypes.c_int32),
            c_ptr(feats, ctypes.c_float), c_ptr(mask, ctypes.c_uint8),
            c_ptr(labels, ctypes.c_int32), c_ptr(valid, ctypes.c_uint8), self.n_threads)
        if rc != 0:
            raise RuntimeError("batch_assemble failed")
        return feats, mask.astype(bool), labels, valid.astype(bool)

    def close(self) -> None:
        if self._handle >= 0:
            self._lib.store_close(self._handle)
            self._handle = -1

    def __del__(self):
        if getattr(self, "_handle", -1) >= 0:
            self.close()
