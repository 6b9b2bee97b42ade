"""PyTorch + CUDA port of seq2seq_vc_tpu for NVIDIA Hopper (H100).

The JAX package ``seq2seq_vc_tpu`` stays the reference; this package
imports ``torch`` and never JAX or anything of the JAX package. Kernels
that the JAX package wrote in Pallas are CUDA C++ under ``csrc/``, built
at first use (``ops/native.py``); each has a plain PyTorch version beside
it that CPU tensors take.
"""

__version__ = "0.1.0"
