"""Flash attention, forward and backward: the hand-written CUDA kernels and
their plain versions.

Counterpart of gpt2_vision_language_tpu/ops/flash_attention.py's dt path.
``csrc/flash_fwd.cu`` replaces ``_fwd_dt_kernel`` (:841, launched by
``_fwd_dt`` :956) and ``csrc/flash_bwd.cu`` replaces ``_bwd_dt_kernel``
(:887, launched by ``_bwd_dt`` :989), behind ``flash_attention_dt`` (:1061)
and ``flash_attention`` (:1089). Both take q/k/v as (B, T, H, hs), strided
views included, so the fused QKV output feeds them without a copy. The
softmax scale 1/sqrt(hs) is applied inside both kernels (the JAX wrapper
folds it into q outside its custom VJP), so the backward scales dq and dk.

``_FlashAttn`` is the autograd Function on both devices: for CUDA tensors
its forward and backward launch the kernels, for CPU tensors they run the
plain versions, ``flash_attention_reference`` and
``flash_attention_backward_reference``. Nothing else selects between them,
and there is no fallback from one to the other. Each forward launch adds
one to ``flash_attention.launches``, each backward launch one to
``flash_attention_backward.launches``.
"""

from __future__ import annotations

import torch

from .. import _build

# head sizes csrc/flash_fwd.cu and csrc/flash_bwd.cu are built for
KERNEL_HEAD_SIZES = (64,)


def flash_attention_reference(q, k, v, *, causal: bool = True):
    """Plain einsum attention over (B, Tq, H, hs) x (B, Tk, H, hs) with an
    fp32 softmax. Returns (o (B, Tq, H, hs) in q.dtype, lse (B, H, Tq) fp32).

    Causal masking is right-aligned (query i sits at position i + Tk - Tq),
    as in gpt2_vision_language_tpu/ops/attention.py xla_sdpa. Like the
    kernels, the probabilities are rounded to v.dtype before the P @ V
    product, which accumulates in fp32.
    """
    tq, tk, hs = q.shape[1], k.shape[1], q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * hs**-0.5
    if causal:
        qpos = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
        kpos = torch.arange(tk, device=q.device)[None, :]
        scores = scores.masked_fill(kpos > qpos, float("-inf"))
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.exp(scores - lse[..., None]).to(v.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return o.to(q.dtype), lse


def flash_attention_backward_reference(q, k, v, o, lse, do, *, causal: bool = True):
    """Plain version of the backward kernel: (dq, dk, dv) in q.dtype from the
    forward's o and lse (B, H, T) and the output cotangent do, all
    (B, T, H, hs). fp32 on upcast operands; P is recomputed from lse, as the
    kernel does, and D = rowsum(do * o)."""
    tq, tk, hs = q.shape[1], k.shape[1], q.shape[-1]
    scale = hs**-0.5
    q32, k32, v32, do32 = (a.float() for a in (q, k, v, do))
    s = torch.einsum("bqhd,bkhd->bhqk", q32, k32) * scale
    if causal:
        qpos = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
        kpos = torch.arange(tk, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, float("-inf"))
    p = torch.exp(s - lse[..., None])
    dd = (do32 * o.float()).sum(-1).transpose(1, 2)  # (B, H, Tq)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do32)
    dp = torch.einsum("bqhd,bkhd->bhqk", do32, v32)
    ds = p * (dp - dd[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k32) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q32) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v):
    if not (q.dim() == 4 and q.shape == k.shape == v.shape):
        raise ValueError(
            "flash_attention takes q, k, v of one (B, T, H, hs) shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.shape[-1] not in KERNEL_HEAD_SIZES:
        raise ValueError(
            f"flash_attention: head size {q.shape[-1]} not in {KERNEL_HEAD_SIZES}"
        )
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")


def _check_kernel_operand(name, a):
    if a.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention kernel takes bf16, got {name} {a.dtype}")
    if a.stride(-1) != 1 or any(s % 8 for s in a.stride()[:3]):
        raise ValueError(
            f"flash_attention kernel: {name} needs unit stride on hs and the "
            f"other strides multiples of 8, got {a.stride()}"
        )
    if a.data_ptr() % 16:
        raise ValueError(f"flash_attention kernel: {name} is not 16-byte aligned")


def flash_fwd_cuda(q, k, v, *, causal: bool):
    """Launch the CUDA kernel: (o (B, T, H, hs) bf16, lse (B, H, T) fp32)."""
    for name, a in (("q", q), ("k", k), ("v", v)):
        _check_kernel_operand(name, a)
    b, t, h, hs = q.shape
    o = torch.empty((b, t, h, hs), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gpt2vl_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b, t, h, hs, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(causal), stream,
        )
    _build.check(err, "flash_fwd")
    flash_attention.launches += 1
    return o, lse


def flash_bwd_cuda(q, k, v, o, lse, do, *, causal: bool):
    """Launch the CUDA backward kernels: (dq, dk, dv), each (B, T, H, hs) bf16."""
    for name, a in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        _check_kernel_operand(name, a)
    if not (o.is_contiguous() and lse.is_contiguous() and lse.dtype == torch.float32):
        raise ValueError("flash_attention backward kernel takes the forward's "
                         "contiguous o and fp32 lse")
    do = do.contiguous()
    b, t, h, hs = q.shape
    dq, dk, dv = (torch.empty((b, t, h, hs), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    dd = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gpt2vl_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dd.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, t, h, hs, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], int(causal), stream,
        )
    _build.check(err, "flash_bwd")
    flash_attention_backward.launches += 1
    return dq, dk, dv


def flash_attention_backward(q, k, v, o, lse, do, *, causal: bool = True):
    """(dq, dk, dv) of flash attention from the forward's o and lse: the
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if q.is_cuda:
        return flash_bwd_cuda(q, k, v, o, lse, do, causal=causal)
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, o, lse, do, causal=causal)
    raise ValueError(f"flash_attention: no kernel for device {q.device}")


flash_attention_backward.launches = 0


class _FlashAttn(torch.autograd.Function):
    """Forward and backward of flash attention; saves (q, k, v, o, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        if q.is_cuda:
            o, lse = flash_fwd_cuda(q, k, v, causal=causal)
        else:
            o, lse = flash_attention_reference(q, k, v, causal=causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, o, lse, do, causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, causal: bool = True, layout: str = "bthd",
                    return_lse: bool = False):
    """Self-attention forward over q/k/v of one shape, (B, T, H, hs) with
    layout="bthd" or (B, H, T, hs) with layout="bhtd"; the output comes back
    in the same layout. With return_lse, also the per-row logsumexp
    (B, H, T) fp32. Any T is taken; a ragged tail is masked.

    CUDA tensors go to the kernels (bf16, head size 64, hs contiguous) and
    anything they do not take raises; CPU tensors go to the plain versions.
    Differentiable in q, k and v (not in lse).
    """
    if layout not in ("bthd", "bhtd"):
        raise ValueError(f"flash_attention: unknown layout {layout!r}")
    if layout == "bhtd":
        q, k, v = (a.transpose(1, 2) for a in (q, k, v))
    _check(q, k, v)
    if not (q.is_cuda or q.device.type == "cpu"):
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    o, lse = _FlashAttn.apply(q, k, v, causal)
    if layout == "bhtd":
        o = o.transpose(1, 2)
    return (o, lse) if return_lse else o


flash_attention.launches = 0
