"""Command line of the PyTorch package.

    python -m <pkg> serve --weights dad_best.pth [--checkpoint emotion2vec_base.pt]

Ported so far: ``serve``, with the JAX package's flags plus ``--device``.
Its encoder runs attention through the hand-written CUDA kernel
(``use_flash_attention=True``). The JAX package's other subcommands are
recognised and exit with status 2, saying they are not ported yet.
"""

from __future__ import annotations

import argparse
import sys

NOT_PORTED = (
    "manifest", "inject", "extract", "pretrain", "d2v-pretrain", "d2v-pack",
    "dad", "infer", "ablation", "sensitivity", "fix-format", "preprocess",
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
