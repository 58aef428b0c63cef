"""PyTorch + CUDA port of the DAD speech-emotion-recognition framework.

A second package beside the JAX reference, module for module: each file
here has its counterpart at the same relative path in the JAX package.
It imports ``torch`` and ``numpy`` only. Entry points (``FeatureExtractor``,
``EmotionPredictor``, ``PredictionServer``, ``cli serve``) run on the GPU
unless the caller passes ``device="cpu"``.

Ported so far:
- the wav -> emotion serving path (configs, encoder, head, extraction,
  serving, the ``serve`` command) with the hand-written Hopper attention
  kernel in ``csrc/attention.cu``;
- the fused extract+train DAD step (``parallel/fused.py``: noise injection,
  augmentation, DACP, ECDA, the optimizer and the teacher EMA);
- every other TPU kernel of the JAX package as a Hopper kernel with its
  plain version: fused LayerNorm and the copy probe (``csrc/fused_norm.cu``)
  and conv + LN + GELU (``csrc/conv.cu``), reached through the ops API and
  ``ops/norm_probe.py``: as in the JAX package, no model code calls them.
"""
