"""Elementary ops as plain functions on tensors.

Counterpart of gpt2_vision_language_tpu/ops/layers.py. Matmuls take the
policy's compute dtype and accumulate in fp32; normalizations run in fp32.
Weights are in torch's nn.Linear layout, (out_features, in_features); the
JAX package stores (in, out).

``matmul_f32`` is ``jnp.dot(..., preferred_element_type=f32)``: on CUDA a
2-D product goes to ``torch.mm(..., out_dtype=torch.float32)``; a batched
one is a bf16 ``torch.matmul`` (fp32 accumulation inside cuBLAS, one
rounding of the result to bf16 that JAX does not make). On the CPU the
operands are upcast, which is exact and matches JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.precision import Policy, DEFAULT_POLICY


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., K) @ b accumulated in fp32, returned in fp32 (see the module
    note for batched low-precision products on CUDA)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.matmul(a, b)
    if not a.is_cuda:
        return torch.matmul(a.float(), b.float())
    if b.dim() == 2:
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    return torch.matmul(a, b).float()


def linear(x, w, b=None, *, policy: Policy = DEFAULT_POLICY):
    """y = x @ w.T + b: compute-dtype operands, fp32 accumulation, the bias
    added in fp32, the result cast to x.dtype."""
    y = matmul_f32(policy.cast_compute(x), policy.cast_compute(w).t())
    if b is not None:
        y = y + b.to(policy.accum_dtype)
    return y.to(x.dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    """LayerNorm over the last axis with fp32 statistics (torch nn.LayerNorm's
    default eps), returned in x.dtype. Forward only: the recompute backward of
    the JAX version (ops/layers.py:57-80) is not ported yet."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def gelu_tanh(x):
    """GELU, tanh approximation (reference MLP, train_gpt2.py:51)."""
    return F.gelu(x, approximate="tanh")


def gelu_exact(x):
    """Exact (erf) GELU (the Q-Former MLP, gpt2_q_former/model.py:128)."""
    return F.gelu(x)


def embed(table, ids):
    """Embedding lookup; the gather stays in the table's dtype."""
    return F.embedding(ids, table)
