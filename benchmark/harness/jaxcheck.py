"""Which of JAX, its libraries and the JAX package a process has loaded."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "gpt2_vision_language_tpu")


def loaded(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default
    ``sys.modules``), each module's name up to its first dot compared whole:
    ``gpt2_vision_language_tpu_torch`` is not ``gpt2_vision_language_tpu``."""
    tops = {name.split(".")[0] for name in (sys.modules if modules is None else modules)}
    return sorted(tops.intersection(FORBIDDEN))
