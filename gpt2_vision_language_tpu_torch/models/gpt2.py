"""GPT-2 decoder: an nn.Module with the reference's names, and the forward
as plain functions over it.

Counterpart of gpt2_vision_language_tpu/models/gpt2.py, decoder only.
The JAX package keeps parameters as a stacked pytree; here they live in an
``nn.Module`` whose submodule names are the reference's
(``transformer.wte/wpe/h.{i}.ln_1/attn.c_attn/attn.c_proj/ln_2/mlp.c_fc/
mlp.c_proj/ln_f`` and a tied ``lm_head``), so reference ``.pt`` files and
``ckpt/torch_export.py`` output load with ``load_state_dict``. The
functions below take that module where the JAX functions take ``params``
and keep the JAX names and arguments.

Self-attention feeds the three strided (B, T, H, hs) views of the fused
QKV output straight to ops/attention.sdpa, which routes causal T >= 512 on
CUDA to the flash kernels (forward and backward). ``loss`` runs lm_head +
CE through ops/fused_ce.fused_linear_ce, which routes a call without
autograd under the bf16 policy on CUDA to the fused CE kernel; under
autograd it takes the chunked plain forward, and both have the chunked
recompute backward, so ``loss`` is differentiable end to end. The tied
wte / lm_head weight gets its gradient from the embedding gather and the
CE head into one fp32 ``.grad``. The parameter dicts below
(``named_params``, ``decay_mask``) are keyed by state-dict name and hold the tied weight once, as
``transformer.wte.weight``. The layer loop is always unrolled; the remat
modes and the gated cross-attention variant are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.config import GPTConfig
from ..core.precision import Policy, DEFAULT_POLICY
from ..ops.attention import sdpa
from ..ops.fused_ce import fused_linear_ce
from ..ops.layers import embed, gelu_tanh, layer_norm, linear, matmul_f32

# ---------------------------------------------------------------------------
# Module and init
# ---------------------------------------------------------------------------


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.c_attn = nn.Linear(cfg.n_embd, 3 * cfg.n_embd)
        self.c_proj = nn.Linear(cfg.n_embd, cfg.n_embd)


class MLP(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.c_fc = nn.Linear(cfg.n_embd, 4 * cfg.n_embd)
        self.c_proj = nn.Linear(4 * cfg.n_embd, cfg.n_embd)


class Block(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.ln_1 = nn.LayerNorm(cfg.n_embd)
        self.attn = CausalSelfAttention(cfg)
        self.ln_2 = nn.LayerNorm(cfg.n_embd)
        self.mlp = MLP(cfg)


class GPT2(nn.Module):
    """Parameter container with the reference's state-dict names; the
    forward is the functions below."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        if cfg.cross_attention:
            raise NotImplementedError(
                "the gated cross-attention decoder is not ported yet "
                "(ROADMAP Queue 1 item 6)"
            )
        self.cfg = cfg
        self.transformer = nn.ModuleDict(
            dict(
                wte=nn.Embedding(cfg.padded_vocab_size, cfg.n_embd),
                wpe=nn.Embedding(cfg.block_size, cfg.n_embd),
                h=nn.ModuleList(Block(cfg) for _ in range(cfg.n_layer)),
                ln_f=nn.LayerNorm(cfg.n_embd),
            )
        )
        self.lm_head = nn.Linear(cfg.n_embd, cfg.padded_vocab_size, bias=False)
        self.lm_head.weight = self.transformer.wte.weight  # tied (train_gpt2.py:97)


@torch.no_grad()
def init(cfg: GPTConfig, *, generator: torch.Generator | None = None,
         device=None) -> GPT2:
    """A GPT-2 with the JAX init's distribution (models/gpt2.py:48-100):
    normal(0, 0.02) for the embeddings, QKV and MLP-in weights, normal(0,
    0.02 * (2 * n_layer) ** -0.5) for the two residual output projections,
    zero biases, unit LayerNorm scales; fp32. Same distribution as the JAX
    init, not the same numbers. ``generator`` must live on ``device``."""
    device = torch.device(device or "cpu")
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    with torch.device(device):
        model = GPT2(cfg)
    proj_std = 0.02 * (2 * cfg.n_layer) ** -0.5
    for name, p in model.named_parameters():
        if name.endswith(("attn.c_proj.weight", "mlp.c_proj.weight")):
            p.normal_(0.0, proj_std, generator=generator)
        elif p.dim() == 2:
            p.normal_(0.0, 0.02, generator=generator)
        elif name.endswith(("ln_1.weight", "ln_2.weight", "ln_f.weight")):
            p.fill_(1.0)
        else:
            p.zero_()
    return model


def named_params(model: nn.Module) -> dict:
    """name -> parameter, the tied wte / lm_head weight once (as
    ``transformer.wte.weight``): the leaves the optimizer updates."""
    return dict(model.named_parameters())


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in named_params(model).values())


def decay_mask(model: nn.Module) -> dict:
    """name -> True where AdamW weight decay applies (models/gpt2.py:801):
    the weights of nn.Linear and nn.Embedding (wte, wpe, every projection);
    not biases or LayerNorm parameters (train_gpt2.py:130-135, torch ndim
    >= 2)."""
    decayed = {id(m.weight) for m in model.modules()
               if isinstance(m, (nn.Linear, nn.Embedding))}
    return {n: id(p) in decayed for n, p in named_params(model).items()}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _ln(x, ln: nn.LayerNorm):
    return layer_norm(x, ln.weight, ln.bias)


def self_attention(attn: CausalSelfAttention, x, cfg: GPTConfig, *,
                   policy: Policy, attn_impl: str):
    """Causal self-attention with fused QKV (train_gpt2.py:33-43). q, k and
    v stay strided (B, T, H, hs) views of the (B, T, 3C) projection."""
    b, t, c = x.shape
    hs = c // cfg.n_head
    qkv = linear(x, attn.c_attn.weight, attn.c_attn.bias, policy=policy)
    q, k, v = (a.view(b, t, cfg.n_head, hs) for a in qkv.split(c, dim=-1))
    cc = policy.cast_compute
    y = sdpa(cc(q), cc(k), cc(v), causal=True, impl=attn_impl, layout="bthd")
    y = y.to(x.dtype).reshape(b, t, c)
    return linear(y, attn.c_proj.weight, attn.c_proj.bias, policy=policy)


def mlp(m: MLP, x, *, policy: Policy):
    """c_fc -> tanh-GELU -> c_proj (train_gpt2.py:46-59)."""
    h = gelu_tanh(linear(x, m.c_fc.weight, m.c_fc.bias, policy=policy))
    return linear(h, m.c_proj.weight, m.c_proj.bias, policy=policy)


def block(layer: Block, x, cfg: GPTConfig, *, policy: Policy,
          attn_impl: str):
    """Pre-LN residual block (train_gpt2.py:62-74)."""
    x = x + self_attention(layer.attn, _ln(x, layer.ln_1), cfg, policy=policy,
                           attn_impl=attn_impl)
    return x + mlp(layer.mlp, _ln(x, layer.ln_2), policy=policy)


def run_blocks(model: GPT2, x, cfg: GPTConfig, *,
               policy: Policy = DEFAULT_POLICY, attn_impl: str = "auto"):
    """The blocks in order, as a Python loop (the JAX unrolled path)."""
    for layer in model.transformer.h:
        x = block(layer, x, cfg, policy=policy, attn_impl=attn_impl)
    return x


def embed_tokens(model: GPT2, idx, cfg: GPTConfig, *, pos_offset: int = 0):
    """wte + wpe embedding sum (train_gpt2.py:114-117)."""
    t = idx.shape[-1]
    pos = torch.arange(pos_offset, pos_offset + t, device=idx.device)
    return (embed(model.transformer.wte.weight, idx)
            + embed(model.transformer.wpe.weight, pos))


def lm_head(model: GPT2, x, cfg: GPTConfig, *,
            policy: Policy = DEFAULT_POLICY):
    """Tied unembedding, ln_f(x) @ wte.T, fp32 accumulation, returned in the
    compute dtype (models/gpt2.py:353-368)."""
    x = _ln(x, model.transformer.ln_f)
    logits = linear(x, model.transformer.wte.weight, policy=policy)
    return logits.to(policy.compute_dtype)


def _check_len(idx, cfg: GPTConfig):
    if idx.shape[-1] > cfg.block_size:
        raise ValueError(
            f"sequence of {idx.shape[-1]} tokens exceeds block_size {cfg.block_size}"
        )


def forward_embeds(model: GPT2, embeds, cfg: GPTConfig, *,
                   policy: Policy = DEFAULT_POLICY, attn_impl: str = "auto"):
    """Blocks + ln_f + lm_head over already-embedded inputs."""
    x = run_blocks(model, embeds, cfg, policy=policy, attn_impl=attn_impl)
    return lm_head(model, x, cfg, policy=policy)


def apply(model: GPT2, idx, cfg: GPTConfig, *, targets=None, target_mask=None,
          policy: Policy = DEFAULT_POLICY, attn_impl: str = "auto"):
    """Full forward. Returns (logits, loss); loss is None without targets
    (train_gpt2.py:111-125)."""
    _check_len(idx, cfg)
    x = embed_tokens(model, idx, cfg).to(policy.compute_dtype)
    logits = forward_embeds(model, x, cfg, policy=policy, attn_impl=attn_impl)
    loss = None
    if targets is not None:
        loss = cross_entropy(logits, targets, mask=target_mask)
    return logits, loss


def loss(model: GPT2, idx, cfg: GPTConfig, *, targets, target_mask=None,
         policy: Policy = DEFAULT_POLICY, attn_impl: str = "auto",
         ce_chunks: int = 8, ce_impl: str = "auto"):
    """CE loss without the (B, T, V) logits: apply(...)[1]'s semantics with
    lm_head + CE through fused_linear_ce. The scoring forward: called without
    autograd (train/step.py make_eval_step) under the bf16 policy on CUDA it
    runs the flash kernel in every layer and the fused CE kernel once. The
    training loss: under autograd on CUDA every layer runs the flash forward
    and, in the backward, the flash backward kernel; CE takes the chunked
    plain forward and backward. ``ce_impl`` is fused_linear_ce's ``impl``."""
    _check_len(idx, cfg)
    x = embed_tokens(model, idx, cfg).to(policy.compute_dtype)
    x = run_blocks(model, x, cfg, policy=policy, attn_impl=attn_impl)
    x = _ln(x, model.transformer.ln_f)
    return fused_ce_loss(x, model.transformer.wte.weight, targets,
                         mask=target_mask, policy=policy, ce_chunks=ce_chunks,
                         impl=ce_impl)


def fused_ce_loss(x, wte, targets, *, mask=None, policy: Policy = DEFAULT_POLICY,
                  ce_chunks: int = 8, impl: str = "auto"):
    """Masked-mean fused CE over final hiddens x (..., T, D); targets equal
    to -100 are ignored (clipped to 0 before the kernel, then masked)."""
    d = x.shape[-1]
    flat_x = x.reshape(-1, d)
    flat_t = targets.reshape(-1)
    ignore = flat_t == -100
    safe_t = torch.where(ignore, torch.zeros_like(flat_t), flat_t)
    nll = fused_linear_ce(flat_x, wte, safe_t, n_chunks=ce_chunks,
                          policy=policy, impl=impl)
    valid = ~ignore
    if mask is not None:
        valid = valid & mask.reshape(-1).bool()
    nll = nll * valid
    return nll.sum() / valid.sum().clamp(min=1)


def cross_entropy(logits, targets, *, mask=None):
    """Token-level CE in fp32: plain mean, or masked mean with the count
    clamped >= 1; targets equal to -100 are ignored."""
    logits = logits.float()
    ignore = targets == -100
    safe = torch.where(ignore, torch.zeros_like(targets), targets)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, safe[..., None].long())[..., 0]
    valid = ~ignore
    if mask is not None:
        valid = valid & mask.bool()
    nll = (logz - gold) * valid
    return nll.sum() / valid.sum().clamp(min=1)


# ---------------------------------------------------------------------------
# KV-cached decode path
# ---------------------------------------------------------------------------


def init_cache(cfg: GPTConfig, batch_size: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """Zeroed (L, B, H, max_len, hs) K and V caches."""
    shape = (cfg.n_layer, batch_size, cfg.n_head, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _cached_sdpa(q, k_cache, v_cache, slot: int, policy: Policy):
    """q rows i (at absolute positions slot + i) attend to cache[j] for
    j <= slot + i. q: (B, H, Tq, hs); caches (B, H, maxT, hs). Only the
    written prefix [0, slot + Tq) is read: the slots past it are masked in
    the JAX version and contribute exactly zero there."""
    tq = q.shape[2]
    kv_len = slot + tq
    k = k_cache[:, :, :kv_len]
    v = v_cache[:, :, :kv_len]
    cc = policy.cast_compute
    scores = matmul_f32(cc(q), cc(k).transpose(-1, -2)) * q.shape[-1] ** -0.5
    qpos = slot + torch.arange(tq, device=q.device)[:, None]
    kpos = torch.arange(kv_len, device=q.device)[None, :]
    scores = scores.masked_fill(kpos > qpos, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = matmul_f32(probs.to(v.dtype), v)
    return out.to(q.dtype)


def run_blocks_cached(model: GPT2, embeds, cfg: GPTConfig, cache, slot: int,
                       policy: Policy):
    x = embeds
    b, t, c = x.shape
    hs = cfg.head_dim
    for l, layer in enumerate(model.transformer.h):
        attn = layer.attn
        qkv = linear(_ln(x, layer.ln_1), attn.c_attn.weight, attn.c_attn.bias,
                     policy=policy)
        q, k, v = (a.view(b, t, cfg.n_head, hs).transpose(1, 2)
                   for a in qkv.split(c, dim=-1))
        # the new rows are written into the stacked cache in place
        cache["k"][l, :, :, slot:slot + t] = k.to(cache["k"].dtype)
        cache["v"][l, :, :, slot:slot + t] = v.to(cache["v"].dtype)
        y = _cached_sdpa(q, cache["k"][l], cache["v"][l], slot, policy)
        y = y.transpose(1, 2).reshape(b, t, c)
        x = x + linear(y, attn.c_proj.weight, attn.c_proj.bias, policy=policy)
        x = x + mlp(layer.mlp, _ln(x, layer.ln_2), policy=policy)
    return x


def forward_cached(model: GPT2, embeds, cfg: GPTConfig, cache, slot: int, *,
                   policy: Policy = DEFAULT_POLICY,
                   last_only: bool = False):
    """Blocks over already-embedded inputs, reading and writing the KV cache
    at [slot, slot + T). Returns (logits, cache): logits over all T positions,
    or over the last one with last_only=True. The cache tensors are updated
    in place. Positional embeddings are the caller's (a visual prefix gets
    none, text restarts at position 0)."""
    x = run_blocks_cached(model, embeds, cfg, cache, slot, policy)
    if last_only:
        x = x[:, -1:, :]
    return lm_head(model, x, cfg, policy=policy), cache
