"""CLIP ViT image encoder: an nn.Module with HF ``CLIPVisionModel``'s names,
and the forward and preprocessing as plain functions.

Counterpart of gpt2_vision_language_tpu/models/clip_vit.py: the encoder the
reference's bridges consume as precomputed patch-token shards (SURVEY.md §6
defect c), with the same names and arguments:

  * ViT with quickGELU (x * sigmoid(1.702 x)), pre-LN blocks, a CLS token,
    learned positional embeddings, ``pre_layrnorm`` / ``post_layernorm``;
  * the patch "conv" is ``patchify`` and one matmul, and the three
    projections of a block one fused QKV product, as in JAX;
  * bf16 compute over fp32 parameters, LayerNorm in fp32: the patch
    embedding stays fp32 (``linear`` returns its input's dtype), the blocks
    carry the compute dtype, attention scores and the softmax are fp32
    (``ops.layers.matmul_f32``), the probabilities are rounded to the compute
    dtype before P @ V, and the attention output is cast back to x's dtype;
  * ``features`` returns all (B, 1 + N, width) tokens, which
    ops/pooling.pool_clip_tokens_to_33 takes (197 for ViT-B/16, 257 for
    ViT-L/14);
  * ``preprocess`` (resize of the shorter side, centre crop, normalisation)
    and ``normalize_only`` on the device.

The parameters live in ``CLIPVisionTower``, whose state-dict names are HF's
with ``vision_model.`` removed (``embeddings.patch_embedding.weight`` in the
conv's (width, 3, p, p) shape, ``encoder.layers.N.self_attn.q_proj`` ...), so
an HF file loads key for key through ``from_hf_state_dict`` (the JAX
module's name for ckpt/torch_import.clip_from_hf_state_dict). Attention is
non-causal at T = 257, 197 or 5 and runs plain in both packages, as the JAX
module's einsum does: no Pallas kernel is on this path.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ckpt.torch_import import clip_from_hf_state_dict as from_hf_state_dict  # noqa: F401
from ..core.config import CLIPConfig
from ..core.precision import Policy, DEFAULT_POLICY
from ..ops.layers import layer_norm, linear, matmul_f32

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def quick_gelu(x):
    """x * sigmoid(1.702 x) as JAX evaluates it in x's dtype: the constant
    in that dtype (1.703125 in bf16), the sigmoid as 1 / (1 + exp(-t)), and
    each step rounded to the dtype, so on bf16 the output is JAX's bit for
    bit (``x * torch.sigmoid(1.702 * x)`` differs in an ulp in about a
    quarter of the elements)."""
    t = x * torch.tensor(1.702, dtype=x.dtype).item()
    return x * (1 / (1 + torch.exp(-t)))


# ---------------------------------------------------------------------------
# Module and init
# ---------------------------------------------------------------------------


class CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        w, p = cfg.width, cfg.patch_size
        self.class_embedding = nn.Parameter(torch.empty(w))
        # the conv's (width, 3, p, p) weight; no bias in CLIP's patch conv
        self.patch_embedding = nn.Conv2d(3, w, p, stride=p, bias=False)
        self.position_embedding = nn.Embedding(cfg.num_tokens, w)


class CLIPAttention(nn.Module):
    def __init__(self, w: int):
        super().__init__()
        self.q_proj = nn.Linear(w, w)
        self.k_proj = nn.Linear(w, w)
        self.v_proj = nn.Linear(w, w)
        self.out_proj = nn.Linear(w, w)


class CLIPMLP(nn.Module):
    def __init__(self, w: int):
        super().__init__()
        self.fc1 = nn.Linear(w, 4 * w)
        self.fc2 = nn.Linear(4 * w, w)


class CLIPEncoderLayer(nn.Module):
    def __init__(self, w: int):
        super().__init__()
        self.self_attn = CLIPAttention(w)
        self.layer_norm1 = nn.LayerNorm(w)
        self.mlp = CLIPMLP(w)
        self.layer_norm2 = nn.LayerNorm(w)


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg.width) for _ in range(cfg.layers))


class CLIPVisionTower(nn.Module):
    """Parameter container with HF CLIPVisionModel's state-dict names
    (``vision_model.`` removed, the historical ``pre_layrnorm`` kept); the
    forward is ``features``."""

    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = CLIPEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.width)
        self.encoder = CLIPEncoder(cfg)
        self.post_layernorm = nn.LayerNorm(cfg.width)


@torch.no_grad()
def init(cfg: CLIPConfig, *, generator: Optional[torch.Generator] = None,
         device=None) -> CLIPVisionTower:
    """An encoder with the JAX init's distribution (models/clip_vit.py:46-75):
    normal(0, width ** -0.5) for the patch, class and position embeddings and
    every projection weight, zero biases, unit LayerNorm scales; fp32. Same
    distribution as the JAX init, not the same numbers. ``generator`` must
    live on ``device``."""
    device = torch.device(device or "cpu")
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    with torch.device(device):
        model = CLIPVisionTower(cfg)
    scale = cfg.width ** -0.5
    for name, p in model.named_parameters():
        if "layrnorm" in name or "layernorm" in name or "layer_norm" in name:
            p.fill_(1.0) if name.endswith("weight") else p.zero_()
        elif name.endswith("bias"):
            p.zero_()
        else:
            p.normal_(0.0, scale, generator=generator)
    return model


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _ln(x, ln: nn.LayerNorm):
    return layer_norm(x, ln.weight, ln.bias)


def plain_attention(q, k, v, policy: Policy):
    """Non-causal attention over (B, H, T, hs) operands as the JAX module's
    einsums compute it: fp32 scores from compute-dtype operands, an fp32
    softmax, the probabilities rounded to the compute dtype, P @ V
    accumulated in fp32; (B, H, T, hs) fp32."""
    cc = policy.cast_compute
    scores = matmul_f32(cc(q), cc(k).transpose(-1, -2)) / q.shape[-1] ** 0.5
    probs = torch.softmax(scores, dim=-1)
    return matmul_f32(probs.to(policy.compute_dtype), cc(v))


def _attn(attn: CLIPAttention, x, heads: int, policy: Policy):
    """Self-attention with one fused QKV product and ``plain_attention``,
    the result in x's dtype."""
    b, t, c = x.shape
    wqkv = torch.cat([attn.q_proj.weight, attn.k_proj.weight, attn.v_proj.weight])
    bqkv = torch.cat([attn.q_proj.bias, attn.k_proj.bias, attn.v_proj.bias])
    qkv = linear(x, wqkv, bqkv, policy=policy)
    q, k, v = (a.view(b, t, heads, c // heads).transpose(1, 2) for a in qkv.split(c, dim=-1))
    y = plain_attention(q, k, v, policy).transpose(1, 2).reshape(b, t, c).to(x.dtype)
    return linear(y, attn.out_proj.weight, attn.out_proj.bias, policy=policy)


def patchify(images, patch: int):
    """(B, H, W, 3) -> (B, N, patch * patch * 3), raster order like the conv,
    each patch flattened over (ph, pw, channel)."""
    b, h, w, c = images.shape
    gh, gw = h // patch, w // patch
    x = images.reshape(b, gh, patch, gw, patch, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, patch * patch * c)


def patch_weight(model: CLIPVisionTower):
    """The conv weight (width, 3, p, p) as the patch matmul's (width,
    p * p * 3) Linear weight, its input ordered (ph, pw, channel) as
    ``patchify`` flattens a patch."""
    w = model.embeddings.patch_embedding.weight
    return w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)


def features(model: CLIPVisionTower, images, cfg: CLIPConfig, *,
             policy: Policy = DEFAULT_POLICY, apply_ln_post: bool = True):
    """(B, H, W, 3) preprocessed images -> (B, 1 + N, width) token features,
    in the compute dtype (fp32 under the fp32 policy)."""
    emb = model.embeddings
    x = linear(patchify(images, cfg.patch_size), patch_weight(model), policy=policy)
    cls = emb.class_embedding.to(x.dtype).expand(x.shape[0], 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1)
    x = x + emb.position_embedding.weight.to(x.dtype)
    x = _ln(x, model.pre_layrnorm).to(policy.compute_dtype)
    for layer in model.encoder.layers:
        x = x + _attn(layer.self_attn, _ln(x, layer.layer_norm1), cfg.heads, policy)
        h = _ln(x, layer.layer_norm2)
        h = quick_gelu(linear(h, layer.mlp.fc1.weight, layer.mlp.fc1.bias, policy=policy))
        x = x + linear(h, layer.mlp.fc2.weight, layer.mlp.fc2.bias, policy=policy)
    if apply_ln_post:
        x = _ln(x, model.post_layernorm)
    return x


# ---------------------------------------------------------------------------
# On-device preprocessing (resize -> centre crop -> normalise)
# ---------------------------------------------------------------------------


def _normalize(x):
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def normalize_only(images_u8):
    """(B, S, S, 3) uint8 already resized and cropped -> CLIP-normalised
    fp32."""
    return _normalize(images_u8.float() / 255.0)


def _resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) fp32 weights of jax.image.resize(method="bilinear")
    along one axis, its antialiasing included: a triangle kernel widened by
    in/out when shrinking, each output's weights normalised to sum 1, outputs
    whose sample falls outside the input zeroed (jax/_src/image/scale.py
    compute_weight_mat, with the same fp32 steps)."""
    f32 = np.float32
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = f32(max(inv_scale, 1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * f32(inv_scale) - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def preprocess(images_u8, size: int = 224):
    """(B, H, W, 3) uint8 -> (B, size, size, 3) fp32, CLIP-normalised: the
    shorter side resized to ``size`` (bilinear, antialiased when shrinking,
    as jax.image.resize), a centre crop, then the normalisation. The resize
    is two products with the separable weight matrices, cut to the crop."""
    b, h, w, _ = images_u8.shape
    x = images_u8.float() / 255.0
    if h < w:
        nh, nw = size, max(size, int(round(w * size / h)))
    else:
        nh, nw = max(size, int(round(h * size / w))), size
    top, left = (nh - size) // 2, (nw - size) // 2
    if nh != h:  # an axis whose size does not change is left as it is, as in JAX
        wh = torch.from_numpy(_resize_matrix(h, nh)[:, top:top + size]).to(x.device)
        x = torch.einsum("bhwc,hi->biwc", x, wh)
    else:
        x = x[:, top:top + size]
    if nw != w:
        ww = torch.from_numpy(_resize_matrix(w, nw)[:, left:left + size]).to(x.device)
        x = torch.einsum("biwc,wj->bijc", x, ww)
    else:
        x = x[:, :, left:left + size]
    return _normalize(x)
