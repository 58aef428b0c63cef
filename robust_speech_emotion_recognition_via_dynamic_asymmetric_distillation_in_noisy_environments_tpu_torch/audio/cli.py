"""Offline noise-injection CLI.

Reproduces the reference's preprocessing scripts in one tool:
- white mode: ``add_noise_to_audio.py`` (gaussian at SNR, seed 42)
- real mode:  ``add_real_noise_to_audio.py`` (NOISEX-92; ``type_specific``
  root1 trees or ``random_noise`` root2 trees)
- verification gate: ``verify_noise_injection.py``

Two engines: ``numpy`` (the reference's serial loop, byte for byte) and
``native`` (the threaded C++ engine of ``audio/native_inject.py``; files its
wav reader cannot parse go through the numpy loop one by one). The native
engine needs its library: when that does not build, ``inject`` raises.

Usage::

    python -m <pkg>.audio.cli inject --input_root R --output_root O \\
        --snr_db 10 --manifest_path train.tsv [--noise_root 5types \\
        --noise_mode type_specific --noise_type babble] [--verify]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..data.manifests import read_manifest
from ..utils import get_logger
from .native_inject import inject_files_native
from .noise import NOISE_FILE_MAPPING, add_real_noise_np, add_white_noise_np, tile_noise_np
from .verify import verify_noise_injection
from .wavio import read_wav, write_wav

logger = get_logger(__name__)


def _load_noise_files(noise_root: str):
    """The NOISEX-92 clips by type, mono-mixed, in float64 as read (the
    numpy engine mixes them so)."""
    noises = {}
    for fname, ntype in NOISE_FILE_MAPPING.items():
        path = os.path.join(noise_root, fname)
        if not os.path.exists(path):
            raise FileNotFoundError(f"missing noise file: {path}")
        audio, _sr = read_wav(path)
        if audio.ndim == 2:
            audio = np.mean(audio, axis=1)
        noises[ntype] = audio
    return noises


def inject(args: argparse.Namespace) -> int:
    if os.path.isdir(args.manifest_path):
        _root, files = read_manifest(args.manifest_path)
    else:
        with open(args.manifest_path, encoding="utf-8") as f:
            lines = [ln for ln in f.read().split("\n") if ln.strip()]
        files = [(ln.split("\t")[0], -1) for ln in lines[1:]]
    relpaths = [rel for rel, _ in files]
    logger.info("injecting noise into %d files at %.1f dB", len(relpaths), args.snr_db)

    rng = np.random.default_rng(args.seed)
    noises = None
    if args.noise_root:
        noises = _load_noise_files(args.noise_root)
        if args.noise_mode == "type_specific" and args.noise_type not in noises:
            raise ValueError(f"unknown noise type {args.noise_type}")
    noise_types = sorted(noises) if noises else []

    in_paths = [os.path.join(args.input_root, rel) for rel in relpaths]
    out_paths = [os.path.join(args.output_root, rel) for rel in relpaths]
    types_per_file = None
    if noises is not None:
        if args.noise_mode == "type_specific":
            types_per_file = [args.noise_type] * len(relpaths)
        else:  # random noise type per sample (root2); pre-draw for determinism
            types_per_file = [
                noise_types[int(rng.integers(len(noise_types)))] for _ in relpaths
            ]

    todo = list(range(len(relpaths)))
    if args.engine == "native":
        seeds = rng.integers(2**63, size=len(relpaths), dtype=np.uint64)
        statuses = inject_files_native(
            in_paths, out_paths, args.snr_db, noise_bank=noises,
            noise_type_per_file=types_per_file, seeds=seeds, n_threads=args.threads,
        )
        # formats the native reader rejects go through the numpy loop per file
        todo = np.nonzero(statuses)[0].tolist()
        if todo:
            logger.info("native engine skipped %d files; numpy fallback", len(todo))

    ok_count = len(relpaths) - len(todo)
    failed = []
    for i in todo:
        try:
            os.makedirs(os.path.dirname(out_paths[i]), exist_ok=True)
            audio, sr = read_wav(in_paths[i])
            if audio.ndim == 2:
                audio = np.mean(audio, axis=1)
            if noises is None:
                noisy = add_white_noise_np(audio, args.snr_db, rng)
            else:
                noise = tile_noise_np(noises[types_per_file[i]], len(audio))
                noisy = add_real_noise_np(audio, noise, args.snr_db)
            write_wav(out_paths[i], noisy, sr)
            ok_count += 1
        except Exception as e:  # noqa: BLE001 (a bad clip must not end the grid)
            if args.engine == "numpy":
                raise  # the numpy engine keeps the reference's fail-fast behaviour
            failed.append(relpaths[i])
            logger.warning("skipping unprocessable %s: %s", relpaths[i], e)
    if failed:
        logger.warning("%d files failed both engines (first: %s)", len(failed), failed[:3])
    logger.info("wrote %d noisy files to %s (%s engine)", ok_count, args.output_root,
                args.engine)

    if args.verify:
        failed_set = set(failed)
        done = [r for r in relpaths if r not in failed_set]
        if not done:
            # an empty sample would pass vacuously with a mean SNR of nan
            logger.error("verification FAILED: no files were written")
            return 2
        ok, results = verify_noise_injection(
            args.input_root, args.output_root, done, args.snr_db,
            tolerance_db=getattr(args, "tolerance", 2.0),
        )
        mean_snr = float(np.mean([s for _, s in results]))
        logger.info("verification %s; mean achieved SNR %.2f dB",
                    "PASSED" if ok else "FAILED", mean_snr)
        return 0 if ok else 2
    return 0


def add_inject_args(p: argparse.ArgumentParser, tolerance: bool = True) -> None:
    """The flags of ``inject``, shared with the package's ``cli inject``,
    which (as the JAX package's) has no ``--tolerance`` and verifies
    within 2 dB."""
    p.add_argument("--input_root", required=True)
    p.add_argument("--output_root", required=True)
    p.add_argument("--snr_db", type=float, default=20.0)
    p.add_argument("--manifest_path", required=True,
                   help="a manifest dir with train.tsv, or a .tsv file")
    p.add_argument("--noise_root", default=None, help="NOISEX-92 5types dir (real-noise mode)")
    p.add_argument("--noise_mode", choices=["type_specific", "random"], default="type_specific")
    p.add_argument("--noise_type", default="babble")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--verify", action="store_true")
    if tolerance:
        p.add_argument("--tolerance", type=float, default=2.0)
    p.add_argument("--engine", choices=["numpy", "native"], default="numpy",
                   help="numpy = the reference's serial loop; native = the threaded "
                        "C++ engine (SNR-exact; its library is built on first use)")
    p.add_argument("--threads", type=int, default=0,
                   help="native engine worker threads (0 = auto)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("inject")
    add_inject_args(p)
    p.set_defaults(func=inject)
    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
