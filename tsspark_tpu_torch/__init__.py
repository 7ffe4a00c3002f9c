"""tsspark_tpu_torch — the PyTorch/CUDA port of tsspark_tpu.

A second package beside the JAX one, for one NVIDIA H100.  This slice
serves forecasts from a parameter registry: the forward model and the
predictive intervals run as two hand-written CUDA kernels
(``csrc/forward.cu``, ``csrc/bands.cu``), with plain PyTorch versions of
both for CPU tensors.  The port imports torch, numpy and scipy, never
JAX and never the JAX package; it keeps its own copies of what it needs
from there (``config``, the checkpoint format, the registry protocol).

Entry points (``ProphetModel``, the ``cuda`` backend, ``PredictionEngine``)
run on the card unless the caller passes ``device="cpu"``, and raise when
no card is present.
"""
