"""Elementary ops as plain functions on tensors.

Counterpart of gpt2_vision_language_tpu/ops/layers.py. Matmuls take the
policy's compute dtype and accumulate in fp32; normalizations run in fp32.
Weights are in torch's nn.Linear layout, (out_features, in_features); the
JAX package stores (in, out).

``matmul_f32`` is ``jnp.dot(..., preferred_element_type=f32)``: on CUDA a
low-precision product goes to ``torch.mm`` / ``torch.bmm`` with
``out_dtype=torch.float32`` (fp32 accumulation, the result never rounded
to the operand dtype). On the CPU the operands are upcast, which is exact
and matches JAX.

``linear`` and ``layer_norm`` are autograd Functions. ``torch.mm`` with
``out_dtype`` has no autograd formula, so ``linear``'s backward uses the
same primitive (compute-dtype operands, fp32 accumulation). ``layer_norm``
has the recompute backward of the JAX custom VJP (ops/layers.py:57-80): it
saves x and the per-row mean and rstd, not the fp32 upcast of x.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.precision import Policy, DEFAULT_POLICY
from ..obs.spans import span


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., M, K) @ b (..., K, N) or b (K, N), accumulated in fp32 and
    returned in fp32 without a rounding to the operands' dtype."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.matmul(a, b)
    if not a.is_cuda:
        return torch.matmul(a.float(), b.float())
    if b.dim() == 2:
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    (m, k), n = a.shape[-2:], b.shape[-1]
    out = torch.bmm(a.expand(*batch, m, k).reshape(-1, m, k),
                    b.expand(*batch, k, n).reshape(-1, k, n), out_dtype=torch.float32)
    return out.reshape(*batch, m, n)


class _Linear(torch.autograd.Function):
    """y = x @ w.T + b with compute-dtype operands and fp32 accumulation;
    dx = dy @ w and dw = dy.T @ x the same way, db in fp32. Spans
    ``linear.fwd`` and ``linear.bwd`` (``obs/spans.py``), the casts and the
    bias add included."""

    @staticmethod
    def forward(ctx, x, w, b, policy):
        with span("linear.fwd"):
            xc = policy.cast_compute(x)
            y = matmul_f32(xc, policy.cast_compute(w).t())
            if b is not None:
                y = y + b.to(policy.accum_dtype)
            ctx.policy = policy
            ctx.x_dtype = x.dtype
            ctx.has_bias = b is not None
            ctx.save_for_backward(xc, w)
            return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        with span("linear.bwd"):
            xc, w = ctx.saved_tensors
            dx, dw, db = linear_backward(dy, xc, w, ctx.policy, ctx.x_dtype, ctx.has_bias,
                                         ctx.needs_input_grad[:3])
            return dx, dw, db, None


def linear_backward(dy, xc, w, policy: Policy, x_dtype, has_bias: bool, needs):
    """(dx, dw, db) of ``linear`` from the output cotangent, the forward's
    compute-dtype input xc and the weight; ``needs`` says which of the three
    are wanted (None for the others)."""
    cc = policy.cast_compute
    dyc = cc(dy)
    dx = dw = db = None
    if needs[0]:
        dx = matmul_f32(dyc, cc(w)).to(x_dtype)
    if needs[1]:
        d = xc.shape[-1]
        dw = matmul_f32(dyc.reshape(-1, dy.shape[-1]).t(), xc.reshape(-1, d)).to(w.dtype)
    if has_bias and needs[2]:
        db = dy.float().reshape(-1, dy.shape[-1]).sum(0)
    return dx, dw, db


def linear(x, w, b=None, *, policy: Policy = DEFAULT_POLICY):
    """y = x @ w.T + b: compute-dtype operands, fp32 accumulation, the bias
    added in fp32, the result cast to x.dtype. Differentiable in x, w, b
    (gradients in their own dtypes)."""
    return _Linear.apply(x, w, b, policy)


def _ln_stats(x32, eps):
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    return mean, torch.rsqrt(var + eps)


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        x32 = x.float()
        mean, rstd = _ln_stats(x32, eps)
        y = (x32 - mean) * rstd * scale.float() + bias.float()
        ctx.save_for_backward(x, scale, mean, rstd)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, scale, mean, rstd = ctx.saved_tensors
        g32 = g.float()
        xhat = (x.float() - mean) * rstd
        red = tuple(range(g32.dim() - 1))  # all leading axes, for the (D,) params
        dscale = dbias = None  # frozen LayerNorm parameters get no gradient work
        if ctx.needs_input_grad[1]:
            dscale = (g32 * xhat).sum(red).to(scale.dtype)
        if ctx.needs_input_grad[2]:
            dbias = g32.sum(red).to(scale.dtype)
        dxhat = g32 * scale.float()
        m1 = dxhat.mean(dim=-1, keepdim=True)
        m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
        dx = (rstd * (dxhat - m1 - xhat * m2)).to(x.dtype)
        return dx, dscale, dbias, None


def layer_norm(x, scale, bias, eps: float = 1e-5):
    """LayerNorm over the last axis with fp32 statistics (torch nn.LayerNorm's
    default eps), returned in x.dtype; the recompute backward of the JAX
    custom VJP."""
    return _LayerNorm.apply(x, scale, bias, eps)


def gelu_tanh(x):
    """GELU, tanh approximation (reference MLP, train_gpt2.py:51)."""
    return F.gelu(x, approximate="tanh")


def gelu_exact(x):
    """Exact (erf) GELU (the Q-Former MLP, gpt2_q_former/model.py:128)."""
    return F.gelu(x)


def embed(table, ids):
    """Embedding lookup; the gather stays in the table's dtype."""
    return F.embedding(ids, table)
