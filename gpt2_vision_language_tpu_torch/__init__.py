"""PyTorch/CUDA port of gpt2_vision_language_tpu for one NVIDIA H100.

The JAX package beside it is the reference; every module here mirrors one
there by name. Plain tensor code is PyTorch; each Pallas TPU kernel on the
ported path is a hand-written CUDA kernel under ``csrc/``, built at first
use by ``_build.py``. This package never imports jax.
"""
