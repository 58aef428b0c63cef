"""The accuracy-parity protocol of the JAX system's ``tools/``, on the port.

- ``torch_replica.py``: the reference-faithful PyTorch replica of both
  trainable stages of the original repo (the yardstick), on the port's
  feature stores, fold splits and metrics, with a ``device`` argument.
- ``run_parity.py``: builds the synthetic clean/noisy corpora and, for N
  seeds, trains supervised pretrain then DAD cross-domain with the port
  and with the replica; writes the per-corpus report beside the JAX
  package's committed per-seed means (``python -m <pkg>.tools.run_parity``).
- ``pool_parity.py``: the pooled verdict over the three corpora.
- ``reports/``: the committed results of the protocol on the card.
"""
