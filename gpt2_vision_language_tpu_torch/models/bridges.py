"""Vision->LM bridges: linear projection and BLIP-2-style Q-Former.

Counterpart of gpt2_vision_language_tpu/models/bridges.py:

  * LinearBridge (gpt2_linear/model.py:114-129): one Linear enc_dim -> d_lm.
  * QFormerBridge (gpt2_q_former/model.py:114-168): vis_proj + 32 learnable
    query tokens + 2 layers (pre-LN query self-attention, query <-> visual
    cross-attention with separate LNs, 4x MLP with EXACT erf GELU, unlike the
    decoder's tanh GELU; residual + dropout 0.1).

The modules are parameter containers with the reference's state-dict names
(``vis_proj``, ``query_tokens``, ``layers.{i}.ln1 / self_attn / ln2_q / ln2_v
/ cross_attn / ln3 / mlp.0 / mlp.2``, the attention parameters packed as
torch ``nn.MultiheadAttention`` packs them: ``in_proj_weight`` (3D, D) rows
[q; k; v], ``in_proj_bias``, ``out_proj``), the names
ckpt/torch_import.py qformer_bridge_from_torch reads. The forward is the
plain functions below, written out as the JAX ``_mha`` is: fp32 scores and
softmax, probabilities cast to the compute dtype, attention-weight dropout
inside the attention and output dropout after each sublayer, all drawn from
one explicit ``torch.Generator`` and active only in training with a
generator.

Init is the torch default the reference actually uses (the bridges are not
nanoGPT-initialized): Linear = U(+-1/sqrt(fan_in)) for weight and bias, MHA
in-proj = Xavier uniform over the packed (3D, D) matrix with zero biases,
out_proj bias zero, query_tokens = N(0, 1). Same distributions as the JAX
init, not the same numbers.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..core.config import BridgeConfig
from ..core.precision import Policy, DEFAULT_POLICY
from ..ops.layers import gelu_exact, layer_norm, linear

# ---------------------------------------------------------------------------
# Modules (parameter containers)
# ---------------------------------------------------------------------------


class LinearBridge(nn.Module):
    def __init__(self, cfg: BridgeConfig, d_lm: int):
        super().__init__()
        self.vis_proj = nn.Linear(cfg.enc_dim, d_lm)


class PackedMHA(nn.Module):
    """The parameters of torch nn.MultiheadAttention under its names."""

    def __init__(self, d: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = nn.Linear(d, d)


class QFormerLayer(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.ln1 = nn.LayerNorm(d)
        self.self_attn = PackedMHA(d)
        self.ln2_q = nn.LayerNorm(d)
        self.ln2_v = nn.LayerNorm(d)
        self.cross_attn = PackedMHA(d)
        self.ln3 = nn.LayerNorm(d)
        self.mlp = nn.Sequential(nn.Linear(d, 4 * d), nn.GELU(), nn.Linear(4 * d, d))


class QFormerBridge(nn.Module):
    def __init__(self, cfg: BridgeConfig, d_lm: int):
        super().__init__()
        self.vis_proj = nn.Linear(cfg.enc_dim, d_lm)
        self.query_tokens = nn.Parameter(torch.empty(cfg.n_queries, d_lm))
        self.layers = nn.ModuleList(QFormerLayer(d_lm) for _ in range(cfg.n_layers))


@torch.no_grad()
def bridge_init(cfg: BridgeConfig, d_lm: int, *,
                generator: Optional[torch.Generator] = None, device=None) -> nn.Module:
    """A bridge with torch's default init drawn from ``generator`` (which must
    live on ``device``); fp32."""
    device = torch.device(device or "cpu")
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    if cfg.kind not in ("linear", "qformer"):
        raise ValueError(f"unknown bridge kind {cfg.kind!r} (xattn lives in gpt2.py)")
    with torch.device(device):
        bridge = (LinearBridge if cfg.kind == "linear" else QFormerBridge)(cfg, d_lm)
    params = dict(bridge.named_parameters())
    for name, p in params.items():
        leaf = name.rsplit(".", 1)[-1]
        if name == "query_tokens":
            p.normal_(0.0, 1.0, generator=generator)
        elif leaf == "in_proj_weight":  # xavier_uniform over the packed matrix
            bound = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
            p.uniform_(-bound, bound, generator=generator)
        elif leaf == "in_proj_bias" or name.endswith("out_proj.bias"):
            p.zero_()
        elif p.dim() == 2:  # Linear weight (out, in)
            bound = 1.0 / math.sqrt(p.shape[1])
            p.uniform_(-bound, bound, generator=generator)
        elif ".ln" in "." + name:  # LayerNorm
            p.fill_(1.0) if leaf == "weight" else p.zero_()
        else:  # Linear bias: U(+-1/sqrt(fan_in)) of its weight
            fan_in = params[name[: -len("bias")] + "weight"].shape[1]
            bound = 1.0 / math.sqrt(fan_in)
            p.uniform_(-bound, bound, generator=generator)
    return bridge


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def linear_bridge_apply(bridge: LinearBridge, patch_tokens, *,
                        policy: Policy = DEFAULT_POLICY):
    return linear(patch_tokens, bridge.vis_proj.weight, bridge.vis_proj.bias, policy=policy)


class RowShard:
    """A generator for one data-parallel rank's rows of a batch whose rows go
    round-robin over ``world`` ranks (data/coco.CocoBatcher's striding: the
    rank's row j is row j * world + rank of the whole batch). Each dropout
    draw takes the whole batch's mask from ``generator`` and keeps the
    rank's rows, so the ranks together draw what one process draws."""

    def __init__(self, generator: torch.Generator, rank: int, world: int):
        self.generator, self.rank, self.world = generator, rank, world


def _uniform(shape, generator, device):
    if isinstance(generator, RowShard):
        whole = torch.rand((shape[0] * generator.world, *shape[1:]),
                           generator=generator.generator, device=device)
        return whole[generator.rank::generator.world]
    return torch.rand(shape, generator=generator, device=device)


def _dropout(x, rate: float, generator, train: bool):
    """Inverted dropout from an explicit generator (on x's device; or a
    ``RowShard`` of one), rows first; the identity unless training with a
    generator and a positive rate."""
    if not train or rate <= 0.0 or generator is None:
        return x
    keep = _uniform(x.shape, generator, x.device) < (1.0 - rate)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _mha(p: PackedMHA, q_in, kv_in, n_heads: int, *, policy, dropout, generator, train):
    """torch nn.MultiheadAttention (batch_first) semantics."""
    b, tq, d = q_in.shape
    hd = d // n_heads
    w, bias = p.in_proj_weight, p.in_proj_bias
    q = linear(q_in, w[:d], bias[:d], policy=policy)
    k = linear(kv_in, w[d:2 * d], bias[d:2 * d], policy=policy)
    v = linear(kv_in, w[2 * d:], bias[2 * d:], policy=policy)
    split = lambda x: x.reshape(b, -1, n_heads, hd).transpose(1, 2)  # noqa: E731
    q, k, v = split(q), split(k), split(v)
    cc = policy.cast_compute
    # compute-dtype operands upcast to fp32: their products and sums are then
    # exactly "fp32 accumulation", and plain autograd differentiates them
    scores = torch.matmul(cc(q).float(), cc(k).float().transpose(-1, -2)) / math.sqrt(hd)
    probs = torch.softmax(scores, dim=-1)
    probs = _dropout(probs, dropout, generator, train)
    out = torch.matmul(probs.to(policy.compute_dtype).float(), cc(v).float())
    out = out.transpose(1, 2).reshape(b, tq, d).to(q_in.dtype)
    return linear(out, p.out_proj.weight, p.out_proj.bias, policy=policy)


def qformer_layer_apply(layer: QFormerLayer, q, v, cfg: BridgeConfig, *, policy,
                        generator=None, train: bool = False):
    """One QFormerLayer (gpt2_q_former/model.py:133-145); five dropout sites."""
    kw = dict(policy=policy, dropout=cfg.dropout, generator=generator, train=train)
    ln = lambda x, m: layer_norm(x, m.weight, m.bias)  # noqa: E731
    q2 = ln(q, layer.ln1)
    sa = _mha(layer.self_attn, q2, q2, cfg.n_heads, **kw)
    q = q + _dropout(sa, cfg.dropout, generator, train)
    ca = _mha(layer.cross_attn, ln(q, layer.ln2_q), ln(v, layer.ln2_v), cfg.n_heads, **kw)
    q = q + _dropout(ca, cfg.dropout, generator, train)
    fc, proj = layer.mlp[0], layer.mlp[2]
    h = gelu_exact(linear(ln(q, layer.ln3), fc.weight, fc.bias, policy=policy))
    h = linear(h, proj.weight, proj.bias, policy=policy)
    return q + _dropout(h, cfg.dropout, generator, train)


def qformer_bridge_apply(bridge: QFormerBridge, patch_tokens, cfg: BridgeConfig, *,
                         policy: Policy = DEFAULT_POLICY, generator=None,
                         train: bool = False):
    """(B, N, enc_dim) -> (B, n_queries, d_lm) refined queries
    (gpt2_q_former/model.py:159-168)."""
    x = linear(patch_tokens, bridge.vis_proj.weight, bridge.vis_proj.bias, policy=policy)
    q = bridge.query_tokens[None].expand(x.shape[0], -1, -1).to(x.dtype)
    for layer in bridge.layers:
        q = qformer_layer_apply(layer, q, x, cfg, policy=policy, generator=generator,
                                train=train)
    return q


def bridge_apply(bridge: nn.Module, patch_tokens, cfg: BridgeConfig, *,
                 policy: Policy = DEFAULT_POLICY, generator=None, train: bool = False):
    if cfg.kind == "linear":
        return linear_bridge_apply(bridge, patch_tokens, policy=policy)
    if cfg.kind == "qformer":
        return qformer_bridge_apply(bridge, patch_tokens, cfg, policy=policy,
                                    generator=generator, train=train)
    raise ValueError(cfg.kind)


def bridge_decay_mask(bridge: nn.Module) -> dict:
    """name -> True where AdamW weight decay applies (configure_optimizers,
    gpt2_q_former/model.py:252-260, torch ndim >= 2): the Linear and packed
    in-proj weights and query_tokens decay; biases and LayerNorm parameters do
    not."""
    return {n: p.dim() >= 2 for n, p in bridge.named_parameters()}
