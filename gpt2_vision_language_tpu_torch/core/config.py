"""GPT-2 decoder and pretraining configuration.

Counterpart of gpt2_vision_language_tpu/core/config.py: GPTConfig and the
GPT-2 family presets (:21-65), ScheduleConfig, OptimizerConfig and
PretrainConfig (:114-240). They are carried here rather than imported
because the JAX package's ``core/__init__`` imports jax. GPTConfig,
ScheduleConfig and OptimizerConfig are the JAX dataclasses field for field;
PretrainConfig carries the fields the single-device trainer honors, and
tests/test_torch_import.py names every JAX field it leaves out.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


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


@dataclass(frozen=True)
class ScheduleConfig:
    """Cosine decay with linear warmup (train_gpt2.py:273-285)."""

    max_lr: float = 6e-4
    min_lr: float = 6e-5
    warmup_steps: int = 715
    max_steps: int = 19073


@dataclass(frozen=True)
class OptimizerConfig:
    """AdamW hyperparameters (train_gpt2.py:127-144): decay on the weights
    only, betas (0.9, 0.95), eps 1e-8, wd 0.1, global-norm clip 1.0."""

    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0


@dataclass(frozen=True)
class PretrainConfig:
    """FineWeb-Edu pretraining workload (train_gpt2.py:243-285), single
    device. The JAX fields for the TPU's memory mechanisms, the big-model
    recipes and model parallelism are not carried
    (tests/test_torch_import.py lists them)."""

    model: GPTConfig = field(
        default_factory=lambda: GPT2_124M.replace(unroll_layers=True)
    )
    total_batch_size: int = 524288  # tokens per optimizer step
    micro_batch_size: int = 8  # B
    seq_len: int = 1024  # T
    schedule: ScheduleConfig = field(default_factory=ScheduleConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    val_every: int = 250
    val_steps: int = 20
    hellaswag_every: int = 250
    sample_every: int = 250
    save_every: int = 2500
    run_hellaswag: bool = True
    data_dir: Optional[str] = None  # defaults to $FW_OUT_DIR or edu_fineweb10B
    log_dir: Optional[str] = None  # defaults to $LOG_DIR or log
    seed: int = 1337
    save_ckpt: bool = True  # False: no checkpoint is written or resumed
    nan_guard: bool = True  # skip the update of a step with a non-finite loss or norm
    attn_impl: str = "auto"

    def grad_accum_steps(self, world_size: int = 1) -> int:
        denom = self.micro_batch_size * self.seq_len * world_size
        if self.total_batch_size % denom:
            raise ValueError(
                "total_batch_size must be divisible by B*T*world_size "
                f"({self.total_batch_size} % {denom})"
            )
        return self.total_batch_size // denom
