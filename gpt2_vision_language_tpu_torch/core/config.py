"""GPT-2 decoder configuration.

Counterpart of gpt2_vision_language_tpu/core/config.py:21-65 (GPTConfig and
the GPT-2 family presets). It is carried here rather than imported because
the JAX package's ``core/__init__`` imports jax. The fields and defaults are
the JAX dataclass's, field for field (pinned by tests/test_torch_import.py).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class GPTConfig:
    """GPT-2 decoder architecture (reference train_gpt2.py:76-83), plus the
    cross-attention variant's ``img_embd``/``cross_attention`` fields.
    ``unroll_layers`` is kept for config parity; this port always runs the
    layers as a Python loop."""

    block_size: int = 1024
    vocab_size: int = 50257
    n_layer: int = 12
    n_head: int = 12
    n_embd: int = 768
    img_embd: int = 0
    cross_attention: bool = False
    unroll_layers: bool = False

    @property
    def head_dim(self) -> int:
        assert self.n_embd % self.n_head == 0
        return self.n_embd // self.n_head

    @property
    def padded_vocab_size(self) -> int:
        # 50257 -> 50304, the reference's construction-time padding
        # (train_gpt2.py:260)
        return _round_up(self.vocab_size, 128)

    def replace(self, **kw) -> "GPTConfig":
        return dataclasses.replace(self, **kw)


GPT2_124M = GPTConfig()
GPT2_350M = GPTConfig(n_layer=24, n_head=16, n_embd=1024)
GPT2_774M = GPTConfig(n_layer=36, n_head=20, n_embd=1280)
GPT2_1558M = GPTConfig(n_layer=48, n_head=25, n_embd=1600)
