"""Command line of the PyTorch package.

    python -m <pkg> manifest --corpus iemocap --root IEMOCAP --eval_dir EVAL --dest MANIFESTS
    python -m <pkg> inject --input_root IEMOCAP --output_root NOISY --manifest_path M --verify
    python -m <pkg> extract --data MANIFESTS --checkpoint emotion2vec_base.pt --save-dir FEATS
    python -m <pkg> pretrain --corpus iemocap --feat-path FEATS --save-dir PM
    python -m <pkg> dad --corpus iemocap --clean FEATS --noisy NOISY_FEATS [--weights pm.ckpt]
    python -m <pkg> dad --corpus iemocap --from-wav MANIFESTS --checkpoint emotion2vec_base.pt
    python -m <pkg> ablation --corpus iemocap --clean FEATS --noisy NOISY_FEATS --suite standard
    python -m <pkg> sensitivity --corpus iemocap --from-wav MANIFESTS --checkpoint ... --knob WEIGHT_ECDA
    python -m <pkg> analyze --kind disagreement --results-dir RESULTS/fold_1
    python -m <pkg> infer --weights dad_best.pth --test-data NOISY_FEATS [--split all]
    python -m <pkg> serve --weights dad_best.pth [--checkpoint emotion2vec_base.pt]
    python -m <pkg> d2v-pretrain --manifests MANIFESTS --save-dir D2V [--init-checkpoint emotion2vec_base.pt]
    python -m <pkg> d2v-pack --manifests MANIFESTS --out-dirs PACKED

Ported so far, each with the JAX package's flags plus ``--device`` where it
touches a tensor (default ``cuda``; ``cpu`` to run on the CPU):
- stage 1, preprocessing: ``manifest`` (IEMOCAP, CASIA, EMODB),
  ``fix-format`` (16 kHz mono), ``inject`` (numpy or native C++ engine,
  ``--verify``), ``extract`` (the feature store; ``--dp``/``--tp`` over a
  process grid) and ``preprocess`` (a noise grid of inject + verify +
  extract, the encoder loaded once);
- ``infer``: a DAD checkpoint over a feature store's fold test split or
  all of it;
- ``serve``;
- ``dad`` on feature stores (``--clean``/``--noisy``): the feature-level
  DAD trainer;
- ``dad --from-wav``: the fused wav->train trainer;
- ``pretrain``: the supervised pretrain stage (the ``.ckpt`` that
  ``--weights`` takes);
- ``ablation`` and ``sensitivity``: the experiment harness, on feature
  stores or ``--from-wav`` (the startup shared by all experiments);
- ``analyze``: disagreement, confirmation bias, DACP evolution, corpus
  distribution and t-SNE (the t-SNE itself needs scikit-learn);
- ``d2v-pretrain``: data2vec-2.0 self-supervised pretraining of the
  encoder (``--binarized`` reads stores from ``d2v-pack``); the encoder
  trains with plain attention (the kernel is forward-only), and ``--prng``
  is accepted with either value, both drawing from one torch generator.
The encoders of ``extract``, ``preprocess``, ``serve`` and the
``--from-wav`` modes run attention through the hand-written CUDA kernel
unless ``--encoder-json`` sets ``use_flash_attention``. The trainers hold
the fold's training corpus on the device when it fits (``--resident
auto``, the default; ``on`` / ``off``). ``dad --fold all``, ``ablation``
and ``sensitivity`` log a failed fold or experiment and go on, then exit
with status 1.

``--dp``/``--tp`` keep the JAX meaning (dp 0 is off; ``dad`` on features
takes dp only) and run one process a device under ``torchrun``, with
max(dp, 1) * tp processes:

    torchrun --standalone --nproc_per_node 2 -m <pkg> dad --from-wav ... --dp 2

Outside ``torchrun`` or at another world size the command exits with
status 2 and prints the launch to use; ``d2v-pretrain --dp/--tp`` exits
with status 2 (ROADMAP.md §1 item 9.5).
"""

from __future__ import annotations

import argparse
import os
import sys

NOT_PORTED = ()  # every subcommand of the JAX package's CLI is ported


def _cmd_manifest(args):
    from .data import manifests

    if args.corpus == "iemocap":
        if args.eval_dir:
            labels = manifests.parse_iemocap_emo_evaluation(args.eval_dir)
            manifests.build_iemocap_manifest(args.root, args.dest, labels=labels)
        else:
            manifests.build_iemocap_manifest(args.root, args.dest, label_path=args.label_path)
    elif args.corpus == "casia":
        manifests.build_casia_manifest(args.root, args.dest)
    else:
        manifests.build_emodb_manifest(args.root, args.dest)
    return 0


def _cmd_fix_format(args):
    from .audio.format import check_audio_format, fix_audio_format

    n_checked = n_fixed = 0
    for dirpath, _dirs, files in os.walk(args.root):
        for fname in sorted(files):
            if not fname.lower().endswith(".wav"):
                continue
            path = os.path.join(dirpath, fname)
            n_checked += 1
            ok, sr, ch = check_audio_format(path, target_sr=args.target_sr)
            if ok:
                continue
            if args.check_only:
                print(f"NONCONFORMING {path}: {sr} Hz, {ch} ch")
            else:
                fix_audio_format(path, path, target_sr=args.target_sr)
            n_fixed += 1
    verb = "flagged" if args.check_only else "fixed"
    print(f"checked {n_checked} wavs; {verb} {n_fixed}")
    return 0


def _cmd_preprocess(args):
    from .exp.preprocess import run_noise_grid

    from .configs import encoder_config

    run_noise_grid(
        manifest_dir=args.manifest_dir,
        clean_root=args.clean_root,
        output_base=args.output_base,
        snrs=[float(x) for x in args.snrs.split(",")],
        noise_types=args.noise_types.split(",") if args.noise_types else None,
        noise_root=args.noise_root,
        root2=args.root2,
        checkpoint=args.checkpoint,
        features_base=args.features_base,
        verify=not args.no_verify,
        engine=args.engine,
        encoder_cfg=encoder_config(args.encoder_json),
        device=args.device,
    )
    return 0


def _add_stage1_parsers(sub) -> None:
    """manifest, inject, extract, infer, fix-format and preprocess."""
    from .audio.cli import add_inject_args, inject
    from .eval import inference
    from .models import extract

    p = sub.add_parser("manifest", help="manifest + label sidecars of a raw corpus")
    p.add_argument("--corpus", choices=["iemocap", "casia", "emodb"], required=True)
    p.add_argument("--root", required=True)
    p.add_argument("--dest", required=True)
    p.add_argument("--label_path", default=None)
    p.add_argument("--eval_dir", default=None, help="IEMOCAP EmoEvaluation dir")
    p.set_defaults(func=_cmd_manifest)

    p = sub.add_parser("inject", help="offline noise injection over a manifest's wav tree")
    add_inject_args(p, tolerance=False)
    p.set_defaults(func=inject)

    p = sub.add_parser("extract", help="emotion2vec feature store of a manifest")
    extract.add_extract_args(p)
    p.set_defaults(func=extract.run)

    p = sub.add_parser("infer", help="a DAD checkpoint over a feature store")
    inference.add_infer_args(p)
    p.set_defaults(func=inference.run)

    p = sub.add_parser("fix-format", help="16 kHz-mono gate (check_and_fix_audio_format.py)")
    p.add_argument("--root", required=True, help="wav tree to walk")
    p.add_argument("--target-sr", type=int, default=16000)
    p.add_argument("--check-only", action="store_true")
    p.set_defaults(func=_cmd_fix_format)

    p = sub.add_parser("preprocess", help="noise-grid injection (+ extraction)")
    p.add_argument("--manifest-dir", required=True)
    p.add_argument("--clean-root", required=True)
    p.add_argument("--output-base", required=True)
    p.add_argument("--snrs", default="0,10,15,20")
    p.add_argument("--noise-types", default=None,
                   help="comma list (babble,f16,...); omit for white noise")
    p.add_argument("--noise-root", default=None, help="NOISEX 5types dir")
    p.add_argument("--root2", action="store_true", help="random type per clip")
    p.add_argument("--checkpoint", default=None, help="extract features too")
    p.add_argument("--encoder-json", default=None,
                   help="EncoderConfig overrides for extraction (inline JSON or a file)")
    p.add_argument("--features-base", default=None)
    p.add_argument("--no-verify", action="store_true")
    p.add_argument("--engine", choices=["numpy", "native"], default="numpy",
                   help="native = threaded C++ injector (SNR-exact)")
    p.add_argument("--device", default="cuda",
                   help="extraction device: cuda (default) or cpu")
    p.set_defaults(func=_cmd_preprocess)


def _cmd_serve(args):
    from .configs import dad_preset
    from .eval.serving import EmotionPredictor, PredictionServer
    from .models.convert import load_torch_file, torch_state_dict_to_ssrl

    cfg = dad_preset(args.corpus)
    ssrl = torch_state_dict_to_ssrl(load_torch_file(args.weights))
    extractor = None
    if args.checkpoint:
        from .configs import encoder_config
        from .models.convert import load_emotion2vec_checkpoint
        from .models.extract import FeatureExtractor

        enc_cfg = encoder_config(dtype=args.encoder_dtype)
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


def _sweep_cfg_kw(args) -> dict:
    """The DAD-config overrides of both ``dad`` modes."""
    kw = dict(pretrained_weight=args.weights or "", epochs=args.epochs)
    if args.warmup_epochs is not None:
        kw["warmup_epochs"] = args.warmup_epochs
        kw["ecda_start_epoch"] = args.warmup_epochs
    if args.batch_size is not None:
        kw["batch_size"] = args.batch_size
    if args.bucket_batches:
        kw["bucket_batches"] = True
    return kw


RESIDENT = {"auto": "auto", "on": True, "off": False}


def _failures_rc(rows: list, what: str, key: str) -> int:
    """A sweep (``--fold all``, an ablation suite, a sensitivity grid) logs
    a failed fold or experiment and goes on to the next; its exit status is
    1 when any row holds an ``"error"`` (a multi-noise row: any of its
    cells)."""
    failed = [r[key] for r in rows
              if "error" in r or any("error" in c for c in r.get("per_noise", {}).values())]
    if not failed:
        return 0
    print(f"dad_torch: error: {what} {failed} of {len(rows)} failed", file=sys.stderr)
    return 1


def _sweep_rc(summary: dict) -> int:
    return _failures_rc(summary["folds"], "fold(s)", "fold")


def _cmd_pretrain(args):
    from .configs import pretrain_preset
    from .train.pretrain import train_with_early_stopping

    # --max-epochs (default 100) overrides the variant's own max_epochs, as
    # in the JAX package's CLI
    cfg = pretrain_preset(args.corpus, variant=args.variant, feat_path=args.feat_path,
                          save_dir=args.save_dir, max_epochs=args.max_epochs)
    folds = tuple(int(f) for f in args.folds.split(",")) if args.folds else None
    train_with_early_stopping(cfg, folds=folds, device=args.device)
    return 0


def _add_pretrain_parser(sub) -> None:
    p = sub.add_parser("pretrain", help="supervised pretrain of the head on a feature store")
    p.add_argument("--corpus", choices=["iemocap", "casia", "emodb"], required=True)
    p.add_argument("--feat-path", required=True)
    p.add_argument("--save-dir", default="train_for_clean_models")
    p.add_argument("--max-epochs", type=int, default=100,
                   help="overrides the variant's max_epochs")
    p.add_argument("--folds", default=None, help="comma-separated 0-based folds")
    p.add_argument("--variant", choices=["default", "advanced", "cosine", "debug"],
                   default="default",
                   help="reference TrainingConfig variants (config.py:4-147)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; without a GPU, cuda fails")
    p.set_defaults(func=_cmd_pretrain)


def _cmd_dad(args):
    from .configs import dad_preset
    from .parallel.mesh import flag_mesh
    from .train import CrossDomainTrainer, run_cv

    if args.from_wav:
        return _cmd_dad_fused(args)
    if not (args.clean and args.noisy):
        raise ValueError("--clean and --noisy are required "
                         "(or use --from-wav for fused training)")
    cfg = dad_preset(args.corpus, clean_data_dir=args.clean, noisy_data_dir=args.noisy,
                     **_sweep_cfg_kw(args))
    # the feature trainer is dp only (JAX cli.py:213-217); a mesh runs per step
    with flag_mesh(args.dp, 1, args.device, getattr(args, "argv", ["dad"])) as mesh:
        common = dict(experiment_name=args.name,
                      scan_chunk=0 if mesh is not None else args.scan_chunk,
                      prefetch_depth=args.prefetch_depth, transfer_dtype=args.transfer_dtype,
                      resident=RESIDENT[args.resident], mesh=mesh, device=args.device)
        if args.fold == "all":
            return _sweep_rc(run_cv(cfg, **common))
        CrossDomainTrainer(cfg, fold=int(args.fold), **common).train(resume=args.resume)
    return 0


def _build_fused_from_args(args, cfg):
    """The encoder config, its weights and the FusedConfig of ``--from-wav``
    from the injection flags. The encoder runs attention through the
    kernel unless ``--encoder-json`` sets ``use_flash_attention``."""
    from .audio.noise import NOISE_TYPES
    from .configs import encoder_config
    from .models.convert import load_emotion2vec_checkpoint
    from .parallel.fused import FusedConfig

    if not args.checkpoint:
        raise ValueError("--from-wav needs --checkpoint (emotion2vec weights)")
    enc_cfg = encoder_config(args.encoder_json, dtype=args.encoder_dtype)
    enc_params = load_emotion2vec_checkpoint(args.checkpoint, enc_cfg)

    snr_choices = (tuple(float(s) for s in args.snr_choices.split(","))
                   if args.snr_choices else None)
    bank_mode, type_idx = None, 0
    if args.noise_root:
        bank_mode = "random" if args.noise_mode == "random" else "fixed"
        if args.noise_type not in NOISE_TYPES:
            raise ValueError(f"unknown noise type {args.noise_type!r}; "
                             f"expected one of {NOISE_TYPES}")
        type_idx = NOISE_TYPES.index(args.noise_type)
    fused_cfg = FusedConfig(
        encoder=enc_cfg,
        dad=cfg,
        inject_snr_db=None if snr_choices else args.snr,
        inject_snr_choices=snr_choices,
        inject_noise_bank_mode=bank_mode,
        inject_noise_type=type_idx,
        cache_clean_features=True,
    )
    return enc_cfg, enc_params, fused_cfg


def _cmd_dad_fused(args):
    """The fused wav->train mode: injection, extraction and the DAD update
    in each step (``train/fused_trainer.py``)."""
    from .configs import dad_preset
    from .parallel.mesh import flag_mesh
    from .train.fused_trainer import FusedCrossDomainTrainer, run_fused_cv

    with flag_mesh(args.dp, args.tp, args.device, getattr(args, "argv", ["dad"])) as mesh:
        cfg = dad_preset(args.corpus, **_sweep_cfg_kw(args))
        enc_cfg, enc_params, fused_cfg = _build_fused_from_args(args, cfg)
        common = dict(
            fused_cfg=fused_cfg,
            noise_root=args.noise_root,
            experiment_name=args.name,
            prefetch_depth=args.prefetch_depth,
            transfer_dtype=args.transfer_dtype,
            resident=RESIDENT[args.resident],
            # per step under a mesh (JAX cli.py:182-183)
            scan_chunk=0 if mesh is not None else args.scan_chunk,
            mesh=mesh,
            device=args.device,
        )
        if args.fold == "all":
            return _sweep_rc(run_fused_cv(cfg, args.from_wav, enc_cfg, enc_params, **common))
        FusedCrossDomainTrainer(cfg, args.from_wav, enc_cfg, enc_params, fold=int(args.fold),
                                **common).train(resume=args.resume)
    return 0


def _cmd_ablation(args):
    from .configs import dad_preset
    from .exp import (
        GRANULAR_ABLATIONS,
        STANDARD_ABLATIONS,
        fused_noise_condition_experiments,
        noise_condition_experiments,
        parse_injection_cells,
        run_ablation_suite,
        run_fused_ablation_suite,
        run_fused_multi_noise_suite,
        run_multi_noise_suite,
    )

    if args.multi_noise and args.suite == "noise":
        raise ValueError(
            "--multi-noise already sweeps noise conditions; pick the "
            "mechanism suite to average (--suite standard or granular)"
        )

    def pick(suite):
        """--experiments: a named subset of the suite (unknown names fail)."""
        if not args.experiments:
            return suite
        names = [n.strip() for n in args.experiments.split(",") if n.strip()]
        unknown = [n for n in names if n not in suite]
        if unknown:
            raise ValueError(f"--experiments {unknown} not in suite {sorted(suite)}")
        return {n: suite[n] for n in names}

    mechanisms = STANDARD_ABLATIONS if args.suite == "standard" else GRANULAR_ABLATIONS
    common = dict(fold=args.fold, device=args.device,
                  trainer_kw={"resident": RESIDENT[args.resident]})
    if args.from_wav:
        cfg = dad_preset(args.corpus, **_sweep_cfg_kw(args))
        enc_cfg, enc_params, fused_cfg = _build_fused_from_args(args, cfg)
        if (args.suite == "noise" or args.multi_noise) and not args.noise_root:
            raise ValueError("--suite noise / --multi-noise with --from-wav "
                             "need --noise-root (NOISEX-92 bank)")
        fused = dict(base_fused_cfg=fused_cfg, noise_root=args.noise_root,
                     output_path=args.output, prefetch_depth=args.prefetch_depth,
                     transfer_dtype=args.transfer_dtype, **common)
        if args.multi_noise:
            # every mechanism averaged over the injection grid
            # (run_granular_ablations*.py semantics, injected on the device)
            results = run_fused_multi_noise_suite(
                cfg, pick(mechanisms), args.from_wav, enc_cfg, enc_params,
                cells=parse_injection_cells(args.multi_noise), **fused)
        else:
            suite = pick(fused_noise_condition_experiments() if args.suite == "noise"
                         else mechanisms)
            results = run_fused_ablation_suite(cfg, suite, args.from_wav, enc_cfg,
                                               enc_params, **fused)
        return _failures_rc(results, "experiment(s)", "name")

    if not (args.clean and args.noisy):
        raise ValueError("--clean and --noisy are required "
                         "(or use --from-wav for fused ablations)")
    cfg = dad_preset(args.corpus, clean_data_dir=args.clean, noisy_data_dir=args.noisy,
                     **_sweep_cfg_kw(args))
    if args.multi_noise:
        results = run_multi_noise_suite(cfg, pick(mechanisms), args.multi_noise.split(","),
                                        output_path=args.output, **common)
    else:
        # with --suite noise, --noisy is the BASE of the offline
        # `root1-{type}-{snr}db` trees (the reference's NOISY_DATA_DIR swaps)
        suite = pick(noise_condition_experiments(args.noisy) if args.suite == "noise"
                     else mechanisms)
        results = run_ablation_suite(cfg, suite, output_path=args.output, **common)
    return _failures_rc(results, "experiment(s)", "name")


def _cmd_sensitivity(args):
    from .configs import dad_preset
    from .exp.sensitivity import run_fused_sensitivity_sweep, run_sensitivity_sweep

    values = [float(x) for x in args.values.split(",")] if args.values else None
    common = dict(values=values, fold=args.fold, output_dir=args.output_dir,
                  device=args.device, trainer_kw={"resident": RESIDENT[args.resident]})
    if args.from_wav:
        cfg = dad_preset(args.corpus, **_sweep_cfg_kw(args))
        enc_cfg, enc_params, fused_cfg = _build_fused_from_args(args, cfg)
        results = run_fused_sensitivity_sweep(
            cfg, args.knob, args.from_wav, enc_cfg, enc_params,
            base_fused_cfg=fused_cfg, noise_root=args.noise_root,
            prefetch_depth=args.prefetch_depth, transfer_dtype=args.transfer_dtype,
            **common)
    else:
        if not (args.clean and args.noisy):
            raise ValueError("--clean and --noisy are required "
                             "(or use --from-wav for fused sweeps)")
        cfg = dad_preset(args.corpus, clean_data_dir=args.clean, noisy_data_dir=args.noisy,
                         **_sweep_cfg_kw(args))
        results = run_sensitivity_sweep(cfg, args.knob, **common)
    return _failures_rc(results, "sweep point(s)", "name")


def _add_sweep_args(p) -> None:
    """The flags ``ablation`` and ``sensitivity`` share: the feature stores,
    the ``--from-wav`` mode's encoder and injection, the trainer's."""
    p.add_argument("--corpus", choices=["iemocap", "casia", "emodb"], required=True)
    p.add_argument("--clean", default=None, help="clean feature dir (feature-level mode)")
    p.add_argument("--noisy", default=None,
                   help="noisy feature dir (feature-level mode); for ablation "
                        "--suite noise the BASE dir of the offline root1-{type}-{snr}db trees")
    p.add_argument("--from-wav", default=None, metavar="MANIFEST_DIR",
                   help="run fused from a clean wav manifest dir (injection on the "
                        "device; replaces --clean/--noisy)")
    p.add_argument("--checkpoint", default=None,
                   help="emotion2vec encoder weights (--from-wav mode)")
    p.add_argument("--encoder-dtype", default="bfloat16")
    p.add_argument("--encoder-json", default=None,
                   help="EncoderConfig overrides as inline JSON or a JSON file "
                        "(--from-wav mode)")
    p.add_argument("--snr", type=float, default=10.0, help="base injection SNR dB (fused)")
    p.add_argument("--snr-choices", default=None,
                   help="comma list; per-clip random SNR (fused multi-SNR)")
    p.add_argument("--noise-root", default=None,
                   help="NOISEX-92 5types dir (fused bank injection; required for "
                        "ablation --suite noise)")
    p.add_argument("--noise-mode", choices=["fixed", "random"], default="fixed")
    p.add_argument("--noise-type", default="babble")
    p.add_argument("--prefetch-depth", type=int, default=2)
    p.add_argument("--transfer-dtype", default=None)
    p.add_argument("--resident", choices=["auto", "on", "off"], default="auto",
                   help="hold each experiment's training corpus on the device "
                        "(both modes); auto does so when it fits 8 GiB")
    p.add_argument("--warmup-epochs", type=int, default=None,
                   help="override WARMUP_EPOCHS (and ECDA_START_EPOCH)")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--bucket-batches", action="store_true",
                   help="bucket-homogeneous training batches (opt-in deviation from "
                        "the reference's batch composition)")
    p.add_argument("--weights", default=None, help="pretrain .ckpt")
    p.add_argument("--fold", type=int, default=0)
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; without a GPU, cuda fails")


def _add_experiment_parsers(sub) -> None:
    p = sub.add_parser("ablation", help="ablation suites (run_ablation_studies*.py)")
    _add_sweep_args(p)
    p.add_argument("--suite", choices=["standard", "granular", "noise"], default="standard")
    p.add_argument("--multi-noise", default=None,
                   help="average every suite experiment across noise conditions "
                        "(run_granular_ablations*.py). Feature mode: comma list of "
                        "noisy feature dirs; fused mode: 'grid' for the full "
                        "injection grid, or a comma list of type@snr cells "
                        "(e.g. babble@10,f16@0)")
    p.add_argument("--experiments", default=None,
                   help="comma-separated subset of the suite's experiment names")
    p.add_argument("--output", default="ablation_results.json")
    p.set_defaults(func=_cmd_ablation)

    p = sub.add_parser("sensitivity", help="hyperparameter sensitivity sweep "
                                           "(run_hyperparameter_sensitivity*.py)")
    _add_sweep_args(p)
    p.add_argument("--knob", required=True,
                   help="e.g. WEIGHT_ECDA, DACP_CALIBRATION_STRENGTH_LAMBDA, "
                        "ECDA_GAMMA_DELTA")
    p.add_argument("--values", default=None, help="comma list; default grid")
    p.add_argument("--output-dir", default="sensitivity_results")
    p.set_defaults(func=_cmd_sensitivity)


def _cmd_analyze(args):
    if args.kind in ("disagreement", "bias", "dacp"):
        from .analysis import (
            analyze_confirmation_bias,
            analyze_dacp_evolution,
            analyze_disagreement,
        )

        fn = {"disagreement": analyze_disagreement, "bias": analyze_confirmation_bias,
              "dacp": analyze_dacp_evolution}[args.kind]
        print(fn(args.results_dir, args.out_dir))
    elif args.kind == "distribution":
        from .analysis import analyze_distribution
        from .configs import CORPUS_PRESETS
        from .data import load_feature_store

        labels = dict(CORPUS_PRESETS[args.corpus]["labels"])
        store = load_feature_store(args.feat_dir, labels)
        print(analyze_distribution(store, list(labels), args.out_dir or "analysis"))
    else:  # tsne
        import torch

        from .analysis import analyze_tsne
        from .configs import dad_preset
        from .data import load_feature_store
        from .models.convert import (
            load_pretrain_head_checkpoint,
            load_torch_file,
            torch_state_dict_to_ssrl,
        )
        from .models.heads import init_ssrl, load_pretrain_into_ssrl

        cfg = dad_preset(args.corpus)
        store = load_feature_store(args.feat_dir, cfg.label_map)
        param_sets = {}
        if args.weights_dad:
            param_sets["dad"] = torch_state_dict_to_ssrl(load_torch_file(args.weights_dad)).student
        if args.weights_pretrain:
            # only the pre_net reaches the embedding, so any fresh init will do
            _h, fresh = init_ssrl(torch.Generator().manual_seed(0), cfg.input_dim,
                                  cfg.hidden_dim)
            pre = load_pretrain_head_checkpoint(args.weights_pretrain)
            param_sets["pretrain"] = load_pretrain_into_ssrl(fresh, pre).student
        print(analyze_tsne(cfg, store, param_sets, args.out_dir or "analysis",
                           device=args.device))
    return 0


def _add_analyze_parser(sub) -> None:
    p = sub.add_parser("analyze", help="analyses of a results dir or a feature store")
    p.add_argument("--kind", required=True,
                   choices=["disagreement", "bias", "dacp", "distribution", "tsne"])
    p.add_argument("--results-dir", default=None)
    p.add_argument("--out-dir", default=None)
    p.add_argument("--feat-dir", default=None, help="for distribution/tsne")
    p.add_argument("--corpus", choices=["iemocap", "casia", "emodb"], default="iemocap")
    p.add_argument("--weights-pretrain", default=None)
    p.add_argument("--weights-dad", default=None)
    p.add_argument("--device", default="cuda",
                   help="tsne's embedding pass: cuda (default) or cpu")
    p.set_defaults(func=_cmd_analyze)


def _add_dad_parser(sub) -> None:
    p = sub.add_parser("dad", help="DAD cross-domain training (features or fused wav)")
    p.add_argument("--corpus", choices=["iemocap", "casia", "emodb"], required=True)
    p.add_argument("--clean", default=None, help="clean feature dir")
    p.add_argument("--noisy", default=None, help="noisy feature dir")
    p.add_argument("--from-wav", default=None, metavar="MANIFEST_DIR",
                   help="fused wav->train mode: train from the wav manifest "
                        "(replaces --clean/--noisy; injection + extraction in each step)")
    p.add_argument("--checkpoint", default=None,
                   help="emotion2vec encoder weights (--from-wav mode)")
    p.add_argument("--encoder-dtype", default="bfloat16", help="(--from-wav mode)")
    p.add_argument("--encoder-json", default=None,
                   help="EncoderConfig overrides as inline JSON or a JSON file "
                        "(--from-wav mode)")
    p.add_argument("--snr", type=float, default=10.0, help="injection SNR dB (--from-wav mode)")
    p.add_argument("--snr-choices", default=None,
                   help="comma-separated SNRs drawn per clip (--from-wav mode)")
    p.add_argument("--noise-root", default=None,
                   help="NOISEX-92 5types dir: bank injection instead of white noise "
                        "(--from-wav mode)")
    p.add_argument("--noise-mode", choices=["fixed", "random"], default="fixed",
                   help="fixed = --noise-type for every clip (root1); random = a "
                        "type per clip (root2)")
    p.add_argument("--noise-type", default="babble",
                   help="NOISEX type for --noise-mode fixed")
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel mesh size (0 = off); under torchrun with "
                        "max(dp, 1) * tp processes")
    p.add_argument("--tp", type=int, default=1,
                   help="encoder tensor-parallel size (fused mode)")
    p.add_argument("--weights", default=None, help="pretrain .ckpt")
    p.add_argument("--fold", default="0", help="0-based fold index or 'all'")
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("--name", default=None)
    # the JAX package defaults to 4 with --resident off, to amortise its
    # per-dispatch uploads; here a chunk only pads and stacks its batches
    # on the host, and 4 took 3x per-step's epoch time on an H100 (PERF.md)
    p.add_argument("--scan-chunk", type=int, default=0,
                   help="batches per chunk (0 = per-batch steps, the "
                        "default; the same history either way). In --from-wav "
                        "mode it chunks the resident corpus only")
    p.add_argument("--prefetch-depth", type=int, default=2,
                   help="batches assembled ahead on a worker thread (0 = sync)")
    p.add_argument("--transfer-dtype", default=None,
                   help="ship f32 features as this dtype + upcast on device "
                        "(e.g. bfloat16; halves H2D bytes, rounds inputs)")
    p.add_argument("--resident", choices=["auto", "on", "off"], default="auto",
                   help="hold the fold's training corpus on the device and gather "
                        "batches there from per-step indices (features: clean + "
                        "noisy stores; --from-wav: cached clean features + raw "
                        "wavs); auto does so when it fits 8 GiB")
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


def _cmd_d2v_pretrain(args):
    from .configs import D2vPretrainConfig, EncoderConfig, load_encoder_json
    from .train.d2v_pretrain import run_d2v_pretrain
    from .utils import MESH_NOT_PORTED

    if args.dp > 0 or args.tp > 1:
        return _refuse(f"--dp/--tp: {MESH_NOT_PORTED}")
    enc_kw = {}
    if args.fast:
        # the JAX package's --fast encoder knobs; --encoder-json still wins
        enc_kw.update(dtype="bfloat16", fast_ln=True, fast_softmax=True, gelu_approximate=True)
    if args.encoder_json:
        enc_kw.update(load_encoder_json(args.encoder_json))
    cfg = EncoderConfig(**enc_kw)
    pcfg = D2vPretrainConfig(
        batch_size=args.batch_size, max_steps=args.steps, warmup_steps=args.warmup_steps,
        learning_rate=args.lr, crop_size=args.crop_size, min_sample_size=args.min_sample_size,
        mask_prob=args.mask_prob, mask_length=args.mask_length, clone_batch=args.clone_batch,
        cls_loss=args.cls_loss, rng_impl=args.prng, ema_dtype=args.ema_dtype,
        adam_mu_dtype=args.adam_mu_dtype, remat_blocks=args.remat,
    )
    weights = [float(w) for w in args.weights.split(",")] if args.weights else None
    run_d2v_pretrain(
        cfg, pcfg, args.manifests, args.save_dir, weights=weights,
        init_checkpoint=args.init_checkpoint, log_every=args.log_every,
        checkpoint_every=args.checkpoint_every, resume=args.resume,
        binarized=args.binarized, transfer_dtype=args.transfer_dtype,
        scan_chunk=args.scan_chunk, valid_manifests=args.valid_manifests,
        valid_split=args.valid_split, valid_every=args.valid_every,
        resident=RESIDENT[args.resident], resident_max_bytes=args.resident_max_bytes,
        device=args.device,
    )
    return 0


def _cmd_d2v_pack(args):
    from .data.binarized import pack_manifest
    from .utils import resolve_device

    resolve_device(args.device)  # packing runs on the host; the flag is checked as everywhere
    if len(args.manifests) != len(args.out_dirs):
        raise ValueError(f"--manifests ({len(args.manifests)}) and --out-dirs "
                         f"({len(args.out_dirs)}) must pair up")
    for mdir, out in zip(args.manifests, args.out_dirs):
        n, total = pack_manifest(mdir, out, split=args.split, sample_rate=args.sample_rate)
        print(f"{mdir} -> {out}: {n} clips, {total} samples")
    return 0


def _add_d2v_parsers(sub) -> None:
    p = sub.add_parser("d2v-pretrain",
                       help="self-supervised data2vec-2.0 pretraining of the encoder")
    p.add_argument("--manifests", nargs="+", required=True,
                   help="manifest dirs (train.tsv); several mix like MultiCorpusDataset")
    p.add_argument("--weights", default=None,
                   help="comma-separated per-manifest sampling weights")
    p.add_argument("--save-dir", required=True)
    p.add_argument("--init-checkpoint", default=None,
                   help="emotion2vec_base.pt to continue pretraining from")
    p.add_argument("--encoder-json", default=None, help="JSON of EncoderConfig overrides")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--steps", type=int, default=100_000)
    p.add_argument("--warmup-steps", type=int, default=8_000)
    p.add_argument("--lr", type=float, default=7.5e-4)
    p.add_argument("--crop-size", type=int, default=160_000)
    p.add_argument("--min-sample-size", type=int, default=32_000,
                   help="skip clips shorter than this many samples")
    p.add_argument("--mask-prob", type=float, default=0.7)
    p.add_argument("--mask-length", type=int, default=5)
    p.add_argument("--clone-batch", type=int, default=8)
    p.add_argument("--cls-loss", type=float, default=1.0)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--checkpoint-every", type=int, default=1000)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel size (not ported yet: > 0 exits 2)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel size (not ported yet: > 1 exits 2)")
    p.add_argument("--binarized", action="store_true",
                   help="--manifests point at packed stores from `d2v-pack`")
    p.add_argument("--prng", choices=["threefry", "rbg"], default="threefry",
                   help="accepted for the JAX CLI's sake: both draw from one torch generator")
    p.add_argument("--ema-dtype", choices=["float32", "bfloat16"], default="float32",
                   help="EMA-teacher storage dtype (the update math stays f32)")
    p.add_argument("--adam-mu-dtype", choices=["bfloat16"], default=None,
                   help="AdamW first-moment storage dtype")
    p.add_argument("--remat", action="store_true",
                   help="recompute the transformer blocks in the backward pass "
                        "(torch.utils.checkpoint): the same gradients, less memory")
    p.add_argument("--transfer-dtype", default=None, metavar="DTYPE",
                   help="ship wav batches host->device in this dtype (e.g. bfloat16; "
                        "quantizes the waveform)")
    p.add_argument("--scan-chunk", type=int, default=1,
                   help="updates per chunk of stacked batches (the same history as per-step)")
    p.add_argument("--valid-manifests", nargs="+", default=None,
                   help="manifest dirs with a <valid-split>.tsv: the masked objective there "
                        "every --valid-every steps, the best state kept")
    p.add_argument("--valid-split", default="valid")
    p.add_argument("--valid-every", type=int, default=1000)
    p.add_argument("--fast", action="store_true",
                   help="bf16 encoder + fast_ln/fast_softmax/tanh-GELU (--encoder-json "
                        "still overrides)")
    p.add_argument("--resident", choices=["auto", "on", "off"], default="auto",
                   help="the normalized training audio on the device once, crops gathered "
                        "there (the same batches; per-step only: auto streams with "
                        "--scan-chunk > 1)")
    p.add_argument("--resident-max-bytes", type=int, default=8 << 30,
                   help="auto mode's device-memory budget for the corpus")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; without a GPU, cuda fails")
    p.set_defaults(func=_cmd_d2v_pretrain)

    p = sub.add_parser("d2v-pack", help="pack wav manifests into float32 stores for "
                                        "`d2v-pretrain --binarized`")
    p.add_argument("--manifests", nargs="+", required=True, help="manifest dirs")
    p.add_argument("--out-dirs", nargs="+", required=True,
                   help="one output dir per manifest dir")
    p.add_argument("--split", default="train")
    p.add_argument("--sample-rate", type=int, default=16_000)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu, checked as by every subcommand; packing "
                        "itself runs on the host")
    p.set_defaults(func=_cmd_d2v_pack)


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
    _add_stage1_parsers(sub)
    _add_pretrain_parser(sub)
    _add_experiment_parsers(sub)
    _add_analyze_parser(sub)
    _add_d2v_parsers(sub)
    return parser


def main(argv=None) -> int:
    from .parallel.mesh import LaunchError

    parser = build_parser()
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser.parse_args(argv)
    args.argv = argv  # for the torchrun launch line of --dp/--tp
    try:
        return args.func(args)
    except LaunchError as e:
        return _refuse(str(e))
    except (FileNotFoundError, ValueError, KeyError) as e:
        parser.exit(2, f"{parser.prog}: error: {e}\n")


if __name__ == "__main__":
    sys.exit(main())
