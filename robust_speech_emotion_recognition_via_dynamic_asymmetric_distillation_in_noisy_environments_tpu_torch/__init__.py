"""PyTorch + CUDA port of the DAD speech-emotion-recognition framework.

A second package beside the JAX reference, module for module: each file
here has its counterpart at the same relative path in the JAX package.
It imports ``torch`` and ``numpy`` only. Entry points (``FeatureExtractor``,
``EmotionPredictor``, ``PredictionServer``, ``cli serve``) run on the GPU
unless the caller passes ``device="cpu"``.

Ported so far: the wav -> emotion serving path (configs, encoder, head,
extraction, serving, the ``serve`` command) with the hand-written Hopper
attention kernel in ``csrc/attention.cu``.
"""
