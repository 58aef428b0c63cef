"""Command line of the PyTorch package.

    python -m <pkg> serve --weights dad_best.pth [--checkpoint emotion2vec_base.pt]
    python -m <pkg> dad --corpus iemocap --clean FEATS --noisy root1-white-10db [--weights pm.ckpt]

Ported so far, each with the JAX package's flags plus ``--device`` (default
``cuda``; ``cpu`` to run on the CPU):
- ``serve``: its encoder runs attention through the hand-written CUDA
  kernel (``use_flash_attention=True``);
- ``dad`` on feature stores (``--clean``/``--noisy``): the feature-level
  DAD trainer. ``--from-wav`` (the fused trainer), ``--dp``/``--tp``
  (multi-GPU) and ``--resident on`` exit with status 2, naming the
  ROADMAP.md item that brings them.
The JAX package's other subcommands are recognised and exit with status 2,
saying they are not ported yet.
"""

from __future__ import annotations

import argparse
import sys

NOT_PORTED = (
    "manifest", "inject", "extract", "pretrain", "d2v-pretrain", "d2v-pack",
    "infer", "ablation", "sensitivity", "fix-format", "preprocess",
    "analyze",
)


def _cmd_serve(args):
    from .configs import dad_preset
    from .eval.serving import EmotionPredictor, PredictionServer
    from .models.convert import load_torch_file, torch_state_dict_to_ssrl

    cfg = dad_preset(args.corpus)
    ssrl = torch_state_dict_to_ssrl(load_torch_file(args.weights))
    extractor = None
    if args.checkpoint:
        from .configs import EncoderConfig
        from .models.convert import load_emotion2vec_checkpoint
        from .models.extract import FeatureExtractor

        enc_cfg = EncoderConfig(dtype=args.encoder_dtype, use_flash_attention=True)
        state = load_emotion2vec_checkpoint(args.checkpoint, enc_cfg)
        extractor = FeatureExtractor(
            enc_cfg, state, batch_size=args.max_batch, device=args.device
        )
    predictor = EmotionPredictor(
        cfg, ssrl, extractor=extractor, batch_size=args.max_batch,
        use_teacher=args.teacher, wav_transfer_dtype=args.wav_dtype,
        device=args.device,
    )
    if not args.no_warmup:
        predictor.warmup()
    server = PredictionServer(
        predictor, host=args.host, port=args.port,
        max_wait_ms=args.max_wait_ms,
    )
    server.serve_forever()
    return 0


def _refuse(what: str) -> int:
    print(f"dad_torch: error: {what}", file=sys.stderr)
    return 2


def _cmd_dad(args):
    from .configs import dad_preset
    from .train import CrossDomainTrainer, run_cv
    from .train.dad_trainer import MESH_NOT_PORTED, RESIDENT_NOT_PORTED

    if args.from_wav:
        return _refuse("--from-wav (the fused wav->train trainer) is not ported yet: "
                       "ROADMAP.md §1 item 3")
    if args.dp > 0 or args.tp > 1:
        return _refuse(f"--dp/--tp: {MESH_NOT_PORTED}")
    if args.resident == "on":
        return _refuse(f"--resident on: {RESIDENT_NOT_PORTED}")
    if not (args.clean and args.noisy):
        raise ValueError("--clean and --noisy are required")
    kw = dict(
        clean_data_dir=args.clean,
        noisy_data_dir=args.noisy,
        pretrained_weight=args.weights or "",
        epochs=args.epochs,
    )
    if args.warmup_epochs is not None:
        kw["warmup_epochs"] = args.warmup_epochs
        kw["ecda_start_epoch"] = args.warmup_epochs
    if args.batch_size is not None:
        kw["batch_size"] = args.batch_size
    if args.bucket_batches:
        kw["bucket_batches"] = True
    cfg = dad_preset(args.corpus, **kw)
    resident = {"auto": "auto", "off": False}[args.resident]
    common = dict(experiment_name=args.name, scan_chunk=args.scan_chunk,
                  prefetch_depth=args.prefetch_depth, transfer_dtype=args.transfer_dtype,
                  resident=resident, device=args.device)
    if args.fold == "all":
        run_cv(cfg, **common)
    else:
        CrossDomainTrainer(cfg, fold=int(args.fold), **common).train(resume=args.resume)
    return 0


def _add_dad_parser(sub) -> None:
    p = sub.add_parser("dad", help="feature-level DAD cross-domain training")
    p.add_argument("--corpus", choices=["iemocap", "casia", "emodb"], required=True)
    p.add_argument("--clean", default=None, help="clean feature dir")
    p.add_argument("--noisy", default=None, help="noisy feature dir")
    # the fused wav->train mode's flags, parsed as the JAX package's CLI
    # parses them; --from-wav itself is refused until that trainer is ported
    p.add_argument("--from-wav", default=None, metavar="MANIFEST_DIR",
                   help="fused wav->train mode (not ported yet: exits 2)")
    p.add_argument("--checkpoint", default=None, help="(--from-wav mode)")
    p.add_argument("--encoder-dtype", default="bfloat16", help="(--from-wav mode)")
    p.add_argument("--encoder-json", default=None, help="(--from-wav mode)")
    p.add_argument("--snr", type=float, default=10.0, help="(--from-wav mode)")
    p.add_argument("--snr-choices", default=None, help="(--from-wav mode)")
    p.add_argument("--noise-root", default=None, help="(--from-wav mode)")
    p.add_argument("--noise-mode", choices=["fixed", "random"], default="fixed",
                   help="(--from-wav mode)")
    p.add_argument("--noise-type", default="babble", help="(--from-wav mode)")
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel size (multi-GPU, not ported yet: > 0 exits 2)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel size (multi-GPU, not ported yet: > 1 exits 2)")
    p.add_argument("--weights", default=None, help="pretrain .ckpt")
    p.add_argument("--fold", default="0", help="0-based fold index or 'all'")
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("--name", default=None)
    # the JAX package defaults to 4 with --resident off, to amortise its
    # per-dispatch uploads; here a chunk only pads and stacks its batches
    # on the host, and 4 took 3x per-step's epoch time on an H100 (PERF.md)
    p.add_argument("--scan-chunk", type=int, default=0,
                   help="batches per chunk (0 = per-batch steps, the "
                        "default; the same history either way)")
    p.add_argument("--prefetch-depth", type=int, default=2,
                   help="batches assembled ahead on a worker thread (0 = sync)")
    p.add_argument("--transfer-dtype", default=None,
                   help="ship f32 features as this dtype + upcast on device "
                        "(e.g. bfloat16; halves H2D bytes, rounds inputs)")
    p.add_argument("--resident", choices=["auto", "on", "off"], default="auto",
                   help="device-resident corpus: not ported yet, 'on' exits 2 "
                        "and 'auto' streams batches from the host")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--warmup-epochs", type=int, default=None,
                   help="override WARMUP_EPOCHS (and ECDA_START_EPOCH)")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--bucket-batches", action="store_true",
                   help="regroup each training epoch into bucket-homogeneous "
                        "batches (opt-in deviation from the reference's batch "
                        "composition)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; without a GPU, cuda fails")
    p.set_defaults(func=_cmd_dad)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="dad_torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("serve", help="micro-batched prediction server")
    p.add_argument("--weights", required=True, help="DAD best .pth")
    p.add_argument("--corpus", choices=["iemocap", "casia", "emodb"],
                   default="iemocap", help="label set / preset")
    p.add_argument("--checkpoint", default=None,
                   help="emotion2vec checkpoint: enables raw-wav requests")
    p.add_argument("--encoder-dtype", default="bfloat16")
    p.add_argument("--wav-dtype", choices=["int16", "float32"],
                   default="int16",
                   help="wav batch host->device transfer dtype; int16 "
                        "halves upload bytes (lossless for PCM sources)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8476)
    p.add_argument("--max-batch", type=int, default=16)
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--teacher", action="store_true")
    p.add_argument("--no-warmup", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; without a GPU, cuda fails")
    p.set_defaults(func=_cmd_serve)
    _add_dad_parser(sub)

    for name in NOT_PORTED:
        sub.add_parser(name, add_help=False, help="not ported yet")
    return parser


def main(argv=None) -> int:
    parser = build_parser()
    args, extra = parser.parse_known_args(argv)
    if args.cmd in NOT_PORTED:
        print(f"{parser.prog}: '{args.cmd}' is not ported to the PyTorch "
              "package yet; use the JAX package's CLI", file=sys.stderr)
        return 2
    if extra:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    try:
        return args.func(args)
    except (FileNotFoundError, ValueError, KeyError) as e:
        parser.exit(2, f"{parser.prog}: error: {e}\n")


if __name__ == "__main__":
    sys.exit(main())
