"""GPT-2 decoder, bridge, pretraining and fine-tune configuration.

Counterpart of gpt2_vision_language_tpu/core/config.py: GPTConfig and the
GPT-2 family presets (:21-65), CLIPConfig and its presets (:69-92),
BridgeConfig (:95-111), ScheduleConfig, OptimizerConfig and PretrainConfig
(:114-240), FinetuneConfig and the three fine-tune presets (:243-309). They
are carried here rather than imported because the JAX package's
``core/__init__`` imports jax. GPTConfig, CLIPConfig, BridgeConfig,
ScheduleConfig, OptimizerConfig and FinetuneConfig are the JAX dataclasses
field for field; PretrainConfig carries the fields the
single-device trainer honors, and tests/test_torch_import.py names every JAX
field it leaves out.
"""

from __future__ import annotations

import dataclasses
import math
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
class CLIPConfig:
    """CLIP ViT image encoder architecture (JAX core/config.py:69-88): the
    defaults are ViT-L/14 (reference README:44-46); the reference bridges are
    built with enc_dim=768 (ViT-B/16), so both are presets."""

    image_size: int = 224
    patch_size: int = 14
    width: int = 1024
    layers: int = 24
    heads: int = 16

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_tokens(self) -> int:
        return self.grid * self.grid + 1  # + CLS


CLIP_VIT_L14 = CLIPConfig()
CLIP_VIT_B16 = CLIPConfig(patch_size=16, width=768, layers=12, heads=12)
CLIP_TINY = CLIPConfig(image_size=32, patch_size=16, width=32, layers=2, heads=2)  # tests


@dataclass(frozen=True)
class BridgeConfig:
    """Vision->LM bridge configuration shared by the three bridge families.

    kind: 'linear' (gpt2_linear/model.py:114-129), 'qformer'
    (gpt2_q_former/model.py:114-168), or 'xattn' (handled by
    GPTConfig.cross_attention instead of a wrapper).
    """

    kind: str = "linear"
    enc_dim: int = 768  # CLIP feature dim fed to the bridge
    n_queries: int = 32  # Q-Former learnable queries / m_vis_tokens
    n_layers: int = 2  # Q-Former depth
    n_heads: int = 12
    dropout: float = 0.1
    use_cls_only: bool = False


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
    """FineWeb-Edu pretraining workload (train_gpt2.py:243-285). ``tp`` is
    the size of the mesh's ``model`` axis: Megatron tensor parallelism over
    that many processes (``seq_parallel`` T-shards the residual stream
    between blocks), or with ``attn_impl="ring"`` the ring size, the number
    of sequence chunks (over processes, or run in turn by one). The
    big-model memory recipes are the JAX fields of the same names
    (``opt_state_dtype``, ``grad_accum_dtype``, ``layerwise_grad``,
    ``param_dtype``; train/optimizer.py, train/step.py, models/gpt2.py). The
    JAX fields for the TPU's memory mechanisms and the pipeline are not
    carried (tests/test_torch_import.py lists them)."""

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
    # AdamW m/v storage: None = fp32 (the reference's), "bfloat16", or "int8"
    # (block-quantized, train/optimizer.py q8_*); the update math stays fp32
    opt_state_dtype: Optional[str] = None
    # None = fp32 grad accumulators; "bfloat16" = stochastically rounded bf16
    # (train/step.py stochastic_round_bf16)
    grad_accum_dtype: Optional[str] = None
    save_ckpt: bool = True  # False: no checkpoint is written or resumed
    nan_guard: bool = True  # skip the update of a step with a non-finite loss or norm
    # True: each micro-batch's grads are formed layer by layer and folded into
    # the accumulators at once (models/gpt2.py loss_grad_layerwise)
    layerwise_grad: bool = False
    # None = fp32 master params; "bfloat16" = the whole model in bf16, as the
    # reference's CUDA run casts it (train_gpt2.py:264)
    param_dtype: Optional[str] = None
    attn_impl: str = "auto"
    # the model axis: Megatron tensor parallelism over tp processes, or the
    # ring size of attn_impl="ring" (sequence chunks)
    tp: int = 1
    seq_parallel: bool = False  # with tp > 1: the residual stream T-sharded between blocks
    # pp > 1: the GPipe pipeline over a ("data", "pipe"[, "model"]) mesh of
    # processes (parallel/pipeline.py), a stage of n_layer / pp layers a rank;
    # pp_micro: GPipe sub-batches a grad-accum micro-batch (0 -> pp)
    pp: int = 1
    pp_micro: int = 0

    def grad_accum_steps(self, world_size: int = 1) -> int:
        denom = self.micro_batch_size * self.seq_len * world_size
        if self.total_batch_size % denom:
            raise ValueError(
                "total_batch_size must be divisible by B*T*world_size "
                f"({self.total_batch_size} % {denom})"
            )
        return self.total_batch_size // denom


@dataclass(frozen=True)
class FinetuneConfig:
    """COCO captioning bridge fine-tune workload.

    linear/qformer preset: gpt2_linear/train.py:55-62,132-144 (B=128, T=32,
    accum=524288/(B*T*world), lr 1e-3->1e-4, warmup 5, 80 steps).
    xattn preset: gpt2_cross-att/train.py:47-49,110-126 (accum=1, warmup 20,
    lr 1e-3->1e-5, steps = 1 epoch of the dataset).
    """

    model: GPTConfig = field(default_factory=lambda: GPT2_124M)
    bridge: BridgeConfig = field(default_factory=BridgeConfig)
    micro_batch_size: int = 128
    seq_len: int = 32  # caption text length
    total_batch_size: int = 524288
    grad_accum_override: Optional[int] = None  # xattn uses 1
    schedule: ScheduleConfig = field(
        default_factory=lambda: ScheduleConfig(
            max_lr=1e-3, min_lr=1e-4, warmup_steps=5, max_steps=80
        )
    )
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    val_every: int = 20
    val_steps: int = 20
    cider_every: int = 20
    cider_samples: int = 500
    cider_max_new_tokens: int = 24
    save_every: int = 2500
    init_ckpt: Optional[str] = None  # pretrained GPT-2 checkpoint to bootstrap
    coco_root: Optional[str] = None
    clip_feats_dir: Optional[str] = None
    log_dir: Optional[str] = None
    seed: int = 1337

    def grad_accum_steps(self, world_size: int = 1) -> int:
        if self.grad_accum_override is not None:
            return self.grad_accum_override
        denom = self.micro_batch_size * self.seq_len * world_size
        if self.total_batch_size % denom:
            raise ValueError(
                "total_batch_size must be divisible by B*T*world_size "
                f"({self.total_batch_size} % {denom})"
            )
        return self.total_batch_size // denom


def finetune_linear_preset(**kw) -> FinetuneConfig:
    return FinetuneConfig(bridge=BridgeConfig(kind="linear"), **kw)


def finetune_qformer_preset(**kw) -> FinetuneConfig:
    return FinetuneConfig(bridge=BridgeConfig(kind="qformer"), **kw)


def finetune_xattn_preset(dataset_size: int = 118287, world_size: int = 1, **kw):
    """Cross-attention preset: 1 epoch at global batch B*world, accum=1
    (gpt2_cross-att/train.py:109-117)."""
    b = kw.pop("micro_batch_size", 128)
    steps = math.ceil(dataset_size / (b * world_size))
    return FinetuneConfig(
        model=GPT2_124M.replace(img_embd=768, cross_attention=True),
        bridge=BridgeConfig(kind="xattn"),
        micro_batch_size=b,
        grad_accum_override=1,
        schedule=ScheduleConfig(
            max_lr=1e-3, min_lr=1e-5, warmup_steps=20, max_steps=steps
        ),
        **kw,
    )
