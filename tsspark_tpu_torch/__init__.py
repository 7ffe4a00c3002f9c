"""tsspark_tpu_torch — the PyTorch/CUDA port of tsspark_tpu.

A second package beside the JAX one, for one NVIDIA H100.  It serves
forecasts from a parameter registry, fits the batched MAP model, and
samples its full posterior with one HMC chain a series; the hot functions
run as hand-written CUDA kernels (``csrc/``: the forward model, the
predictive intervals, the loss and its gradient, the line-search fan, the
posterior-predictive forecast), each with a plain PyTorch version for CPU
tensors.  The port imports torch, numpy and scipy, never
JAX and never the JAX package; it keeps its own copies of what it needs
from there (``config``, the checkpoint format, the registry protocol).

Entry points (``ProphetModel``, the ``cuda`` backend, ``PredictionEngine``)
run on the card unless the caller passes ``device="cpu"``, and raise when
no card is present.
"""
