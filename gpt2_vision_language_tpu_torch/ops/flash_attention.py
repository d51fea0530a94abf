"""Flash-attention forward: the hand-written CUDA kernel and its plain version.

Counterpart of gpt2_vision_language_tpu/ops/flash_attention.py, forward
only: the kernel in ``csrc/flash_fwd.cu`` replaces ``_fwd_dt_kernel``
(:841, launched by ``_fwd_dt`` :956) behind ``flash_attention_dt`` (:1061)
and ``flash_attention`` (:1089). It takes q/k/v as (B, T, H, hs), strided
views included, so the fused QKV output feeds it without a copy.

``flash_attention`` runs the kernel for CUDA tensors and the plain version,
``flash_attention_reference``, for CPU tensors; nothing else selects
between them, and there is no fallback from one to the other. Each kernel
launch adds one to ``flash_attention.launches``.
"""

from __future__ import annotations

import torch

from .. import _build

# head sizes csrc/flash_fwd.cu is built for
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


class _FlashFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        return flash_fwd_cuda(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, do, dlse):
        raise NotImplementedError(
            "flash_attention backward is not ported yet (ROADMAP Queue 2, "
            "K1-bwd: _bwd_dt_kernel)"
        )


def flash_attention(q, k, v, *, causal: bool = True, layout: str = "bthd",
                    return_lse: bool = False):
    """Self-attention forward over q/k/v of one shape, (B, T, H, hs) with
    layout="bthd" or (B, H, T, hs) with layout="bhtd"; the output comes back
    in the same layout. With return_lse, also the per-row logsumexp
    (B, H, T) fp32. Any T is taken; a ragged tail is masked.

    CUDA tensors go to the kernel (bf16, head size 64, hs contiguous) and
    anything it does not take raises; CPU tensors go to the plain version.
    """
    if layout not in ("bthd", "bhtd"):
        raise ValueError(f"flash_attention: unknown layout {layout!r}")
    if layout == "bhtd":
        q, k, v = (a.transpose(1, 2) for a in (q, k, v))
    _check(q, k, v)
    if q.is_cuda:
        o, lse = _FlashFwd.apply(q, k, v, causal)
    elif q.device.type == "cpu":
        o, lse = flash_attention_reference(q, k, v, causal=causal)
    else:
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if layout == "bhtd":
        o = o.transpose(1, 2)
    return (o, lse) if return_lse else o


flash_attention.launches = 0
