"""PyTorch/CUDA port of uce_tpu for one NVIDIA H100.

Mirrors ``uce_tpu``'s file layout; imports torch, numpy and the standard
library only (never jax or uce_tpu). Each TPU kernel on a ported path is a
hand-written Hopper kernel under ``csrc/``, built at first use.
"""

__version__ = "0.1.0"
