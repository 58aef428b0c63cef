"""PyTorch + CUDA port of the DAD speech-emotion-recognition framework.

A second package beside the JAX reference, module for module: each file
here has its counterpart at the same relative path in the JAX package.
It imports ``torch`` and ``numpy`` only (and scipy's resampler in
``audio/format.py``). Entry points (``FeatureExtractor``,
``EmotionPredictor``, ``PredictionServer``, ``cli serve``) run on the GPU
unless the caller passes ``device="cpu"``; so do ``CrossDomainTrainer``,
``FusedCrossDomainTrainer``, ``CrossDomainInference``, ``extract_manifest``
and the CLI's subcommands.

Ported so far:
- the wav -> emotion serving path (configs, encoder, head, extraction,
  serving, the ``serve`` command) with the hand-written Hopper attention
  kernel in ``csrc/attention.cu``;
- the fused extract+train DAD step (``parallel/fused.py``: noise injection,
  augmentation, DACP, ECDA, the optimizer and the teacher EMA);
- every other TPU kernel of the JAX package as a Hopper kernel with its
  plain version: fused LayerNorm and the copy probe (``csrc/fused_norm.cu``)
  and conv + LN + GELU (``csrc/conv.cu``), reached through the ops API and
  ``ops/norm_probe.py``: as in the JAX package, no model code calls them;
- the feature-level DAD trainer (``train/dad_trainer.py``, ``cli dad
  --clean --noisy``) and the host plumbing under it: feature stores, fold
  splits, bucketed batching, the prefetch pipeline, metrics, reports,
  anchor calibration, the chunked epoch runner, checkpoints;
- the fused wav->train trainer (``train/fused_trainer.py``, ``cli dad
  --from-wav``), its attention through the kernel, and its wav plumbing:
  wav I/O (``audio/wavio.py``), the numpy injectors and NOISEX loaders
  (``audio/noise.py``), manifests, the wav store and its batches
  (``data/manifests.py``, ``data/wavstore.py``);
- the device-resident training corpus of both trainers
  (``parallel/resident.py``; ``--resident auto``, the default);
- stage 1 and inference: the corpus manifests (``data/manifests.py``),
  the 16 kHz mono gate (``audio/format.py``), offline noise injection with
  its verification (``audio/cli.py``, ``audio/verify.py``; the native C++
  engine through ``audio/native_inject.py``), offline extraction
  (``models/extract.py::extract_manifest``, attention through the
  kernel), the noise grid (``exp/preprocess.py``) and cross-corpus
  inference (``eval/inference.py``), with the native host library
  (``data/native.py``: built from ``native/*.cc`` on first use for the
  native injection engine; its batcher, ``NativeStore``, is bound and
  tested, while the trainers and ``infer`` assemble batches in numpy).
"""
