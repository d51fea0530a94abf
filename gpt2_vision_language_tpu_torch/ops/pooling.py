"""CLIP token pooling with torch adaptive_avg_pool2d's bins.

Counterpart of gpt2_vision_language_tpu/ops/pooling.py. The reference
compresses CLIP's (1 CLS + side*side patch) tokens to 33 by
adaptive-average-pooling the patch grid to (4, 8) and re-attaching CLS, then
L2-normalizing per token (pool_clip_197_to_33_avg_with_cls,
gpt2_linear/model.py:240-254).

torch's adaptive pooling uses bins [floor(i*in/out), ceil((i+1)*in/out)),
overlapping and uneven when ``out`` does not divide ``in`` (14 -> 4). As in
the JAX package, the bins are two static averaging matrices and the pooling is
the contraction Wh @ grid @ Ww^T in fp32, so 14- and 16-grids give the JAX
values sum for sum; ``F.adaptive_avg_pool2d`` computes the same function.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _adaptive_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) row-stochastic matrix replicating torch's bin formula."""
    w = np.zeros((out_size, in_size), np.float32)
    for i in range(out_size):
        start = (i * in_size) // out_size
        end = math.ceil((i + 1) * in_size / out_size)
        w[i, start:end] = 1.0 / (end - start)
    return w


def adaptive_avg_pool2d(x, out_hw):
    """x (..., H, W) -> (..., oh, ow), torch.nn.functional parity."""
    oh, ow = out_hw
    h, w = x.shape[-2], x.shape[-1]
    wh = torch.from_numpy(_adaptive_matrix(h, oh)).to(x.device)
    ww = torch.from_numpy(_adaptive_matrix(w, ow)).to(x.device)
    y = torch.einsum("ph,...hw->...pw", wh, x.float())
    y = torch.einsum("qw,...pw->...pq", ww, y)
    return y.to(x.dtype)


def pool_clip_tokens_to_33(tokens, *, out_hw=(4, 8)):
    """(B, 1+side*side, D) CLIP tokens -> (B, 33, D): CLS + pooled grid,
    L2-normalized per token (gpt2_linear/model.py:240-254). Handles any
    square grid (197 for ViT-B/16, 257 for ViT-L/14)."""
    b, _, d = tokens.shape
    cls = tokens[:, :1, :]
    patches = tokens[:, 1:, :]
    n = patches.shape[1]
    side = int(round(n**0.5))
    if side * side != n:
        raise ValueError(f"expected a square patch grid, got N={n}")
    grid = patches.reshape(b, side, side, d).permute(0, 3, 1, 2)  # (B, D, s, s)
    pooled = adaptive_avg_pool2d(grid, out_hw)  # (B, D, oh, ow)
    m = out_hw[0] * out_hw[1]
    pooled = pooled.reshape(b, d, m).transpose(1, 2)  # (B, m, D)
    z = torch.cat([cls, pooled], dim=1).float()
    norm = z.square().sum(-1, keepdim=True).sqrt()
    # torch F.normalize: x / max(||x||, eps), eps=1e-12
    return (z / norm.clamp(min=1e-12)).to(tokens.dtype)
