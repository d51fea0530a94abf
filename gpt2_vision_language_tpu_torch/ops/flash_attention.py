"""Flash attention, forward and backward: the hand-written CUDA kernels and
their plain versions.

Counterpart of gpt2_vision_language_tpu/ops/flash_attention.py, three kernel
families behind ``flash_attention`` (:1089 there) and
``flash_attention_with_lse`` (:752):

  * the self-attention family (Tq == Tk, T <= K1_MAX_T): ``csrc/flash_fwd.cu``
    (bf16) and ``csrc/flash_fwd_f32.cu`` (fp32 operands, true fp32 products)
    replace ``_fwd_dt_kernel`` (:841, launched by ``_fwd_dt`` :956), which
    takes either, and ``csrc/flash_bwd.cu`` (bf16) and
    ``csrc/flash_bwd_f32.cu`` (fp32, its own D kernel) replace
    ``_bwd_dt_kernel`` (:887, ``_bwd_dt`` :989), which takes either too;
  * the general family (Tq != Tk, any length, right-aligned causal or
    non-causal): ``csrc/flash_general_fwd.cu`` replaces the streamed-K/V
    forward ``_fwd_kernel_grid`` (:221, launched by ``_fwd`` :265),
    ``csrc/flash_dq_bwd.cu`` replaces ``_dq_kernel_grid`` (:369) and
    ``csrc/flash_dkv_bwd.cu`` ``_dkv_kernel_grid`` (:509), both launched by
    ``_bwd`` (:550). As there, the two backward kernels take D = rowsum(dO *
    O) as an input tensor; the small kernel of ``csrc/flash_general_bwd.cu``
    forms it (``_bwd`` leaves it to XLA, :573);
  * the lse family, the same shapes again, behind ``flash_attention_with_lse``
    and ``flash_attention(stream_kv=False)``: ``csrc/flash_lse_fwd.cu``
    replaces ``_fwd_kernel`` (:197, launched by ``_fwd`` :265 with
    stream_kv=False) and ``csrc/flash_fused_bwd.cu`` replaces the one-pass
    ``_bwd_kernel_fused`` (:396, ``_bwd`` :550). Its logsumexp output is
    differentiable: the backward takes the cotangent of lse as
    dcap = D - dlse (:576-580 there), which is what makes the merge of ring
    attention's chunks exact in the gradient too.

The JAX kernels are dtype-generic (their outputs take q.dtype, :294, :607,
:636-637, :670-672), and so are the three families here: inside each, fp32
operands go to kernels of true fp32 products (FFMAs, no TF32), anything else
to the bf16 ones. The fp32 kernels: ``csrc/flash_fwd_f32.cu`` and
``csrc/flash_bwd_f32.cu`` (the self-attention family, the backward with its
own D kernel); ``csrc/flash_general_fwd_f32.cu`` behind
``flash_general_forward_f32`` (K2b's function); ``csrc/flash_lse_fwd_f32.cu``
behind ``flash_lse_forward_f32`` (K2a's: the same forward block, each query
tile's key range split into parts that fill the card's waves, merged in a
fixed order; ``lse_f32_parts`` picks how many, ``flash_lse_split_reference``
is its plain version); ``csrc/flash_general_bwd_f32.cu``, one
kernel that takes the row term as an input, behind
``flash_general_backward_f32`` (K3a's and K3b's, on D) and
``flash_fused_backward_f32`` (K3c's, on D - dlse); and the fp32 D kernel of
``csrc/flash_bwd_f32.cu`` behind ``flash_rowdot_f32``.

All take q as (B, Tq, H, hs) and k/v as (B, Tk, H, hs), strided views
included, so the fused QKV output feeds them without a copy. The softmax
scale 1/sqrt(hs) is applied inside the kernels (the JAX wrapper folds it
into q outside its custom VJP), so the backward kernels scale dq and dk.

``_FlashAttn``, ``_FlashAttnGeneral`` and ``_FlashAttnLse`` are the autograd
Functions of the three families on both devices: for CUDA tensors their
forward and backward launch the kernels, for CPU tensors they run the plain
versions, ``flash_attention_reference``, ``rowdot_reference``,
``flash_attention_backward_reference`` and
``flash_fused_backward_reference``. Nothing else selects between kernel
and plain version, and there is no fallback from one to the other, from one
family or dtype to the other, or to any library call: what a kernel does not
take raises. Each launch adds one to its wrapper's count:
``flash_attention.launches``, ``flash_forward_f32.launches``,
``flash_attention_backward.launches`` and ``flash_bwd_f32_cuda.launches``
for the self-attention family,
``flash_general_forward.launches``, ``flash_general_dq.launches``,
``flash_general_dkv.launches`` and ``flash_rowdot.launches`` for the
general one (fp32: ``flash_general_forward_f32.launches``,
``flash_general_backward_f32.launches``, ``flash_rowdot_f32.launches``),
``flash_lse_forward.launches`` and ``flash_fused_backward.launches`` (and
``flash_rowdot.launches`` for its D) for the lse family (fp32:
``flash_lse_forward_f32.launches``, ``flash_fused_backward_f32.launches``,
``flash_rowdot_f32.launches``).
"""

from __future__ import annotations

import functools
import heapq

import torch

from .. import _build

# head sizes the kernels in csrc/ are built for
KERNEL_HEAD_SIZES = (64,)

# The longest self-attention the first family takes. It is DT_MAX_T of the JAX
# package (ops/flash_attention.py:823 dt_eligible), kept so that both packages
# send the same shapes to counterpart kernels: Tq == Tk up to this length to
# the self-attention kernels, everything else to the general ones.
K1_MAX_T = 8192


def _causal_mask(tq, tk, device):
    """(Tq, Tk) bool, True where query i (at position i + Tk - Tq) does not
    see key j."""
    qpos = torch.arange(tq, device=device)[:, None] + (tk - tq)
    kpos = torch.arange(tk, device=device)[None, :]
    return kpos > qpos


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
        scores = scores.masked_fill(_causal_mask(tq, tk, q.device), float("-inf"))
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.exp(scores - lse[..., None]).to(v.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return o.to(q.dtype), lse


def rowdot_reference(do, o):
    """Plain version of the D pre-kernel: D = rowsum(dO * O) in fp32,
    (B, T, H, hs) x 2 -> (B, H, T)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2)


def flash_attention_backward_reference(q, k, v, o, lse, do, *, causal: bool = True,
                                       dd=None):
    """Plain version of the backward kernels: (dq, dk, dv) in the operands'
    dtypes from the forward's o and lse (B, H, Tq) and the output cotangent
    do; q, o, do are (B, Tq, H, hs), k, v are (B, Tk, H, hs). fp32 on upcast
    operands; P is recomputed from lse, as the kernels do. ``dd`` is D
    (B, H, Tq) fp32 where the caller has it (the general kernels take it as
    an input); without it D = rowsum(do * o) is formed here."""
    tq, tk, hs = q.shape[1], k.shape[1], q.shape[-1]
    scale = hs**-0.5
    q32, k32, v32, do32 = (a.float() for a in (q, k, v, do))
    s = torch.einsum("bqhd,bkhd->bhqk", q32, k32) * scale
    if causal:
        s = s.masked_fill(_causal_mask(tq, tk, q.device), float("-inf"))
    p = torch.exp(s - lse[..., None])
    if dd is None:
        dd = rowdot_reference(do, o)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do32)
    dp = torch.einsum("bqhd,bkhd->bhqk", do32, v32)
    ds = p * (dp - dd[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k32) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q32) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v, causal):
    if not (q.dim() == 4 and k.dim() == 4 and k.shape == v.shape
            and q.shape[0] == k.shape[0] and q.shape[2:] == k.shape[2:]):
        raise ValueError(
            "flash_attention takes q (B, Tq, H, hs) and k, v of one (B, Tk, H, hs) "
            f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.shape[-1] not in KERNEL_HEAD_SIZES:
        raise ValueError(
            f"flash_attention: head size {q.shape[-1]} not in {KERNEL_HEAD_SIZES}"
        )
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if not (q.is_cuda or q.device.type == "cpu"):
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if causal and q.shape[1] > k.shape[1]:
        raise ValueError(
            "causal flash attention requires Tq <= Tk (right-aligned queries); "
            f"got Tq={q.shape[1]} Tk={k.shape[1]}"
        )


def _check_kernel_operand(name, a):
    if a.dtype != torch.bfloat16:
        raise ValueError(
            f"flash_attention bf16 kernel takes bf16, got {name} {a.dtype} (fp32 operands "
            "go to the fp32 kernels of each family; no kernel takes another dtype)")
    if a.stride(-1) != 1 or any(s % 8 for s in a.stride()[:3]):
        raise ValueError(
            f"flash_attention kernel: {name} needs unit stride on hs and the "
            f"other strides multiples of 8, got {a.stride()}"
        )
    if a.data_ptr() % 16:
        raise ValueError(f"flash_attention kernel: {name} is not 16-byte aligned")


def _check_stats(o, lse, dd=None):
    stats = (lse,) if dd is None else (lse, dd)
    if not (o.is_contiguous()
            and all(a.is_contiguous() and a.dtype == torch.float32 for a in stats)):
        raise ValueError("flash_attention backward kernels take the forward's "
                         "contiguous o and contiguous fp32 lse and D")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _strides(q, k, v):
    return (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])


# ---------------------------------------------------------------------------
# The self-attention family (Tq == Tk)
# ---------------------------------------------------------------------------


def flash_fwd_cuda(q, k, v, *, causal: bool):
    """Launch the CUDA kernel: (o (B, T, H, hs) bf16, lse (B, H, T) fp32)."""
    for name, a in (("q", q), ("k", k), ("v", v)):
        _check_kernel_operand(name, a)
    b, t, h, hs = q.shape
    o = torch.empty((b, t, h, hs), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.gpt2vl_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b, t, h, hs, *_strides(q, k, v), int(causal), _stream(q),
        )
    _build.check(err, "flash_fwd")
    flash_attention.launches += 1
    return o, lse


def flash_bwd_cuda(q, k, v, o, lse, do, *, causal: bool):
    """Launch the CUDA backward kernels: (dq, dk, dv), each (B, T, H, hs) bf16.
    do is made contiguous first (the cotangent of a sum comes expanded, all
    strides 0)."""
    do = do.contiguous()
    for name, a in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        _check_kernel_operand(name, a)
    _check_stats(o, lse)
    b, t, h, hs = q.shape
    dq, dk, dv = (torch.empty((b, t, h, hs), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    dd = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.gpt2vl_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dd.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, t, h, hs, *_strides(q, k, v), int(causal), _stream(q),
        )
    _build.check(err, "flash_bwd")
    flash_attention_backward.launches += 1
    return dq, dk, dv


def _check_f32_operand(name, a):
    """The fp32 kernels read q/k/v through strides 16 bytes at a time: fp32,
    unit stride on hs, the other strides multiples of 4 floats, 16-byte
    aligned. The fused QKV view (strides (T 3C, 3C, hs, 1)) and the ring's
    chunk views of it pass without a copy."""
    if a.dtype != torch.float32:
        raise ValueError(f"flash_attention fp32 kernels take fp32, got {name} {a.dtype}")
    if a.stride(-1) != 1 or any(s % 4 for s in a.stride()[:3]):
        raise ValueError(
            f"flash_attention fp32 kernels: {name} needs unit stride on hs and the "
            f"other strides multiples of 4, got {a.stride()}"
        )
    if a.data_ptr() % 16:
        raise ValueError(f"flash_attention fp32 kernels: {name} is not 16-byte aligned")


def flash_forward_f32(q, k, v, *, causal: bool = True):
    """Self-attention forward (Tq == Tk) on fp32 operands, (o (B, T, H, hs)
    fp32, lse (B, H, T) fp32): the kernel of csrc/flash_fwd_f32.cu for CUDA
    tensors (every product an fp32 FMA, no TF32, as the JAX kernel's products
    on fp32 operands), the plain version for CPU tensors."""
    if not q.is_cuda:
        return flash_attention_reference(q, k, v, causal=causal)
    for name, a in (("q", q), ("k", k), ("v", v)):
        _check_f32_operand(name, a)
    b, t, h, hs = q.shape
    o = torch.empty((b, t, h, hs), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.gpt2vl_flash_fwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b, t, h, hs, *_strides(q, k, v), int(causal), _stream(q),
        )
    _build.check(err, "flash_fwd_f32")
    flash_forward_f32.launches += 1
    return o, lse


flash_forward_f32.launches = 0


def flash_bwd_f32_cuda(q, k, v, o, lse, do, *, causal: bool):
    """Launch the fp32 backward kernels of csrc/flash_bwd_f32.cu (D, then dq
    and dk/dv in one grid; every product an fp32 FMA, no TF32): (dq, dk, dv),
    each (B, T, H, hs) fp32."""
    do = do.contiguous()
    for name, a in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        _check_f32_operand(name, a)
    _check_stats(o, lse)
    b, t, h, hs = q.shape
    dq, dk, dv = (torch.empty((b, t, h, hs), dtype=torch.float32, device=q.device)
                  for _ in range(3))
    dd = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.gpt2vl_flash_bwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dd.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, t, h, hs, *_strides(q, k, v), int(causal), _stream(q),
        )
    _build.check(err, "flash_bwd_f32")
    flash_bwd_f32_cuda.launches += 1
    return dq, dk, dv


flash_bwd_f32_cuda.launches = 0


def flash_attention_backward(q, k, v, o, lse, do, *, causal: bool = True):
    """(dq, dk, dv) of self-attention (Tq == Tk) from the forward's o and
    lse: for CUDA tensors the fp32 kernel on fp32 q, the bf16 one otherwise;
    the plain version for CPU tensors."""
    if q.is_cuda and q.dtype == torch.float32:
        return flash_bwd_f32_cuda(q, k, v, o, lse, do, causal=causal)
    if q.is_cuda:
        return flash_bwd_cuda(q, k, v, o, lse, do, causal=causal)
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, o, lse, do, causal=causal)
    raise ValueError(f"flash_attention: no kernel for device {q.device}")


flash_attention_backward.launches = 0


class _FlashAttn(torch.autograd.Function):
    """Forward and backward of the self-attention family; saves
    (q, k, v, o, lse). On CUDA tensors fp32 q goes to the fp32 kernels,
    anything else to the bf16 ones."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        if q.is_cuda and q.dtype == torch.float32:
            o, lse = flash_forward_f32(q, k, v, causal=causal)
        elif q.is_cuda:
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


# ---------------------------------------------------------------------------
# The general family (Tq != Tk, streamed K/V)
# ---------------------------------------------------------------------------


def flash_general_forward(q, k, v, *, causal: bool = True):
    """General forward, (o (B, Tq, H, hs), lse (B, H, Tq) fp32): the bf16
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if not q.is_cuda:
        return flash_attention_reference(q, k, v, causal=causal)
    for name, a in (("q", q), ("k", k), ("v", v)):
        _check_kernel_operand(name, a)
    b, tq, h, hs = q.shape
    o = torch.empty((b, tq, h, hs), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.gpt2vl_flash_general_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b, tq, k.shape[1], h, hs, *_strides(q, k, v), int(causal), _stream(q),
        )
    _build.check(err, "flash_general_fwd")
    flash_general_forward.launches += 1
    return o, lse


flash_general_forward.launches = 0


def flash_general_forward_f32(q, k, v, *, causal: bool = True):
    """General forward on fp32 operands (K2b's function), (o (B, Tq, H, hs)
    fp32, lse (B, H, Tq) fp32): the kernel of csrc/flash_general_fwd_f32.cu
    for CUDA tensors (every product an fp32 FMA, no TF32), the plain version
    for CPU tensors."""
    if not q.is_cuda:
        return flash_attention_reference(q, k, v, causal=causal)
    for name, a in (("q", q), ("k", k), ("v", v)):
        _check_f32_operand(name, a)
    b, tq, h, hs = q.shape
    o = torch.empty((b, tq, h, hs), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.gpt2vl_flash_general_fwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b, tq, k.shape[1], h, hs, *_strides(q, k, v), int(causal), _stream(q),
        )
    _build.check(err, "flash_general_fwd_f32")
    flash_general_forward_f32.launches += 1
    return o, lse


flash_general_forward_f32.launches = 0


def flash_rowdot(do, o):
    """D = rowsum(dO * O), (B, H, T) fp32, from contiguous (B, T, H, hs)
    tensors: for CUDA tensors the pre-kernel of the general backward, or on
    fp32 operands the fp32 one (flash_rowdot_f32); the plain version for CPU
    tensors."""
    if not do.is_cuda:
        return rowdot_reference(do, o)
    if do.dtype == torch.float32:
        return flash_rowdot_f32(do, o)
    for name, a in (("do", do), ("o", o)):
        _check_kernel_operand(name, a)
    if not (do.is_contiguous() and o.is_contiguous() and do.shape == o.shape):
        raise ValueError("flash_rowdot takes contiguous do and o of one shape")
    b, t, h, hs = o.shape
    dd = torch.empty((b, h, t), dtype=torch.float32, device=o.device)
    lib = _build.load()
    with torch.cuda.device(o.device):
        err = lib.gpt2vl_flash_rowdot(do.data_ptr(), o.data_ptr(), dd.data_ptr(),
                                      b, t, h, hs, _stream(o))
    _build.check(err, "flash_rowdot")
    flash_rowdot.launches += 1
    return dd


flash_rowdot.launches = 0


def flash_rowdot_f32(do, o):
    """D = rowsum(dO * O), (B, H, T) fp32, from contiguous fp32 (B, T, H, hs)
    tensors: the D kernel of csrc/flash_bwd_f32.cu for CUDA tensors, the
    plain version for CPU tensors."""
    if not do.is_cuda:
        return rowdot_reference(do, o)
    for name, a in (("do", do), ("o", o)):
        _check_f32_operand(name, a)
    if not (do.is_contiguous() and o.is_contiguous() and do.shape == o.shape):
        raise ValueError("flash_rowdot_f32 takes contiguous do and o of one shape")
    b, t, h, hs = o.shape
    dd = torch.empty((b, h, t), dtype=torch.float32, device=o.device)
    lib = _build.load()
    with torch.cuda.device(o.device):
        err = lib.gpt2vl_flash_rowdot_f32(do.data_ptr(), o.data_ptr(), dd.data_ptr(),
                                          b, t, h, hs, _stream(o))
    _build.check(err, "flash_rowdot_f32")
    flash_rowdot_f32.launches += 1
    return dd


flash_rowdot_f32.launches = 0


def _general_bwd_args(q, k, v, do, lse, dd, causal, check=_check_kernel_operand):
    for name, a in (("q", q), ("k", k), ("v", v), ("do", do)):
        check(name, a)
    _check_stats(do, lse, dd)
    b, tq, h, hs = q.shape
    if lse.shape != (b, h, tq) or dd.shape != (b, h, tq):
        raise ValueError(f"lse and D must be (B, H, Tq) = {(b, h, tq)}, got "
                         f"{tuple(lse.shape)}, {tuple(dd.shape)}")
    return (b, tq, k.shape[1], h, hs, *_strides(q, k, v), int(causal), _stream(q))


def flash_general_dq(q, k, v, do, lse, dd, *, causal: bool = True):
    """dq (B, Tq, H, hs) of general attention from lse and D (both (B, H, Tq)
    fp32) and a contiguous do: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if not q.is_cuda:
        return flash_attention_backward_reference(q, k, v, None, lse, do, causal=causal,
                                                  dd=dd)[0]
    tail = _general_bwd_args(q, k, v, do, lse, dd, causal)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.gpt2vl_flash_general_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            dd.data_ptr(), dq.data_ptr(), *tail,
        )
    _build.check(err, "flash_general_dq")
    flash_general_dq.launches += 1
    return dq


flash_general_dq.launches = 0


def flash_general_dkv(q, k, v, do, lse, dd, *, causal: bool = True):
    """(dk, dv), each (B, Tk, H, hs), of general attention; arguments as
    flash_general_dq."""
    if not q.is_cuda:
        return flash_attention_backward_reference(q, k, v, None, lse, do, causal=causal,
                                                  dd=dd)[1:]
    tail = _general_bwd_args(q, k, v, do, lse, dd, causal)
    dk, dv = (torch.empty(k.shape, dtype=k.dtype, device=k.device) for _ in range(2))
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.gpt2vl_flash_general_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            dd.data_ptr(), dk.data_ptr(), dv.data_ptr(), *tail,
        )
    _build.check(err, "flash_general_dkv")
    flash_general_dkv.launches += 1
    return dk, dv


flash_general_dkv.launches = 0


def _f32_backward(entry, q, k, v, do, lse, dd, causal):
    # The kernel is a persistent grid whose blocks wait on one another's parts
    # of dq, so all of them must be resident at once: it is launched
    # cooperatively, the runtime places every block at once or fails the
    # launch (a grid sized for the whole card where only a share of its SMs
    # is this process's, under MPS), and the failure raises here. Its flags
    # are its own, taken and zeroed on the current stream.
    tail = _general_bwd_args(q, k, v, do, lse, dd, causal, check=_check_f32_operand)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = (torch.empty(k.shape, dtype=torch.float32, device=k.device) for _ in range(2))
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.gpt2vl_flash_general_bwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            dd.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *tail,
        )
    _build.check(err, entry)
    return dq, dk, dv


def flash_general_backward_f32(q, k, v, do, lse, dd, *, causal: bool = True):
    """(dq, dk, dv) of general attention on fp32 operands (K3a's and K3b's
    functions, in one launch) from lse and D (both (B, H, Tq) fp32) and a
    contiguous do: the kernel of csrc/flash_general_bwd_f32.cu for CUDA
    tensors (every product an fp32 FMA, no TF32, no atomics), the plain
    version for CPU tensors."""
    if not q.is_cuda:
        return flash_attention_backward_reference(q, k, v, None, lse, do, causal=causal, dd=dd)
    out = _f32_backward("flash_general_bwd_f32", q, k, v, do, lse, dd, causal)
    flash_general_backward_f32.launches += 1
    return out


flash_general_backward_f32.launches = 0


def flash_general_backward(q, k, v, o, lse, do, *, causal: bool = True):
    """(dq, dk, dv) of general attention from the forward's o and lse: D from
    flash_rowdot, then for CUDA tensors the fp32 kernel on fp32 q
    (flash_general_backward_f32), else the dq and the dk/dv kernels; for CPU
    tensors the plain version with that D passed in."""
    do = do.contiguous()
    dd = flash_rowdot(do, o)
    if q.is_cuda and q.dtype == torch.float32:
        return flash_general_backward_f32(q, k, v, do, lse, dd, causal=causal)
    if q.is_cuda:
        dq = flash_general_dq(q, k, v, do, lse, dd, causal=causal)
        dk, dv = flash_general_dkv(q, k, v, do, lse, dd, causal=causal)
        return dq, dk, dv
    return flash_attention_backward_reference(q, k, v, o, lse, do, causal=causal, dd=dd)


class _FlashAttnGeneral(torch.autograd.Function):
    """Forward and backward of the general family; saves (q, k, v, o, lse).
    On CUDA tensors fp32 q goes to the fp32 kernels, anything else to the
    bf16 ones."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        if q.is_cuda and q.dtype == torch.float32:
            o, lse = flash_general_forward_f32(q, k, v, causal=causal)
        else:
            o, lse = flash_general_forward(q, k, v, causal=causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_general_backward(q, k, v, o, lse, do, causal=ctx.causal)
        return dq, dk, dv, None


# ---------------------------------------------------------------------------
# The lse family (differentiable logsumexp, one-pass backward)
# ---------------------------------------------------------------------------


def flash_attention_with_lse_reference(q, k, v, *, causal: bool = True):
    """Plain version of the lse forward: flash_attention_reference, whose lse
    is differentiable through plain autograd."""
    return flash_attention_reference(q, k, v, causal=causal)


def flash_fused_backward_reference(q, k, v, do, lse, dcap, *, causal: bool = True):
    """Plain version of the one-pass backward kernel: (dq, dk, dv) from the
    forward's lse and the row term dcap = D - dlse, both (B, H, Tq) fp32, as
    the kernel takes them."""
    return flash_attention_backward_reference(q, k, v, None, lse, do, causal=causal, dd=dcap)


def flash_lse_forward(q, k, v, *, causal: bool = True):
    """Forward with logsumexp, (o (B, Tq, H, hs), lse (B, H, Tq) fp32): the
    bf16 kernel for CUDA tensors, the plain version for CPU tensors."""
    if not q.is_cuda:
        return flash_attention_with_lse_reference(q, k, v, causal=causal)
    for name, a in (("q", q), ("k", k), ("v", v)):
        _check_kernel_operand(name, a)
    b, tq, h, hs = q.shape
    o = torch.empty((b, tq, h, hs), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.gpt2vl_flash_lse_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b, tq, k.shape[1], h, hs, *_strides(q, k, v), int(causal), _stream(q),
        )
    _build.check(err, "flash_lse_fwd")
    flash_lse_forward.launches += 1
    return o, lse


flash_lse_forward.launches = 0


# The split fp32 lse forward (csrc/flash_lse_fwd_f32.cu): query tiles of 128
# rows, key tiles of 64, at most this many parts a query tile, and the share
# of the resident slots a list schedule of the parts must keep busy
LSE_F32_ROWS = 128
KEY_TILE = 64
LSE_F32_MAX_PARTS = 8
LSE_F32_BALANCE = 0.9


def lse_f32_visible_tiles(tq: int, tk: int, causal: bool) -> list[int]:
    """The key tiles each 128-row query tile of the split fp32 lse forward
    sweeps (csrc/flash_f32.cuh visible_key_tiles): every one, or under the
    right-aligned causal mask those up to the last one its last row sees."""
    ntk = -(-tk // KEY_TILE)
    return [(min(qt * LSE_F32_ROWS + LSE_F32_ROWS, tq) - 1 + tk - tq) // KEY_TILE + 1
            if causal else ntk for qt in range(-(-tq // LSE_F32_ROWS))]


def lse_f32_chunk(tk: int, parts: int) -> int:
    """The most key tiles a part holds: the last query row sees every key, so
    the longest visible range, ceil(Tk / 64) tiles, is cut into ``parts``."""
    return -(-(-(-tk // KEY_TILE)) // parts)


def split_makespan(bh: int, visible, slots: int, parts: int) -> tuple[int, int, int]:
    """(work, makespan, split items) of a split forward's grid, its query
    tiles seeing ``visible`` key tiles each (the split fp32 lse forward's and
    P1 fp32's grids, csrc/flash_f32.cuh FwdSplit): the key tiles its items
    sweep, those the busiest of ``slots`` resident blocks sweeps under the
    list schedule that hands each item, in the grid's order (the longest
    query tiles first, each one's parts of at most ceil(max(visible) /
    parts) tiles in turn, (b, h) fastest), to the first slot that comes free
    (empty parts take no time), and the items of the query tiles cut into
    more than one part, which the merge reads."""
    chunk = -(-max(visible) // parts)
    lengths = [min(chunk, n - p * chunk) for n in reversed(visible)
               for p in range(parts) if p * chunk < n for _ in range(bh)]
    free = [0] * slots
    for length in lengths:
        heapq.heapreplace(free, free[0] + length)
    split = sum(-(-n // chunk) for n in visible if n > chunk) * bh
    return sum(lengths), max(free), split


def split_balance(bh: int, visible, slots: int, parts: int) -> float:
    """The share of ``slots`` resident blocks that a split forward's items
    keep busy: its work over slots x the makespan (``split_makespan``)."""
    work, span, _ = split_makespan(bh, visible, slots, parts)
    return work / (slots * span)


def lse_f32_balance(bh: int, tq: int, tk: int, causal: bool, slots: int, parts: int) -> float:
    """``split_balance`` of the split fp32 lse forward's grid."""
    return split_balance(bh, lse_f32_visible_tiles(tq, tk, causal), slots, parts)


@functools.lru_cache(maxsize=256)
def lse_f32_parts(bh: int, tq: int, tk: int, causal: bool, slots: int) -> int:
    """Parts a query tile of the split fp32 lse forward: the fewest (up to
    LSE_F32_MAX_PARTS) whose schedule keeps LSE_F32_BALANCE of the slots
    busy, else the best balanced; 1 where a block a query tile already fills
    the card's waves."""
    balance = {}
    for parts in range(1, LSE_F32_MAX_PARTS + 1):
        balance[parts] = lse_f32_balance(bh, tq, tk, causal, slots, parts)
        if balance[parts] >= LSE_F32_BALANCE:
            return parts
    return max(balance, key=balance.get)


def lse_f32_parts_reference(q, k, v, *, causal: bool, parts: int):
    """Plain version of the split kernel's items: for each 128-row query tile
    of (B, Tq, H, hs) q against (B, Tk, H, hs) k and v, its rows and, in part
    order, each part's (o before the division by its row sum (B, rows, H,
    hs), running max m (B, H, rows), row sum l (B, H, rows)) over its key
    tiles, fp32; a row that sees none of a part's keys has m = -1e30 and
    l = 0, as in the kernel."""
    tq, tk, hs = q.shape[1], k.shape[1], q.shape[-1]
    chunk = lse_f32_chunk(tk, parts)
    q32, k32, v32 = (a.float() for a in (q, k, v))
    for qt, n in enumerate(lse_f32_visible_tiles(tq, tk, causal)):
        rows = slice(qt * LSE_F32_ROWS, min(qt * LSE_F32_ROWS + LSE_F32_ROWS, tq))
        s = torch.einsum("bqhd,bkhd->bhqk", q32[:, rows], k32) * hs**-0.5
        if causal:
            s = s.masked_fill(_causal_mask(tq, tk, q.device)[rows], float("-inf"))
        out = []
        for p in range(parts):
            if p * chunk >= n:
                break
            keys = slice(p * chunk * KEY_TILE, min((p * chunk + chunk) * KEY_TILE, tk))
            sp = s[..., keys]
            m = sp.amax(-1).clamp_min(-1e30)
            e = torch.exp(sp - m[..., None])
            out.append((torch.einsum("bhqk,bkhd->bqhd", e, v32[:, keys]), m, e.sum(-1)))
        yield rows, out


def merge_lse_parts(parts):
    """(o (B, rows, H, hs), lse (B, H, rows)) of a query tile from its parts
    (``lse_f32_parts_reference``), merged in their order as the kernel's merge
    does: M = max m, L = sum l exp(m - M), o = sum o exp(m - M) / L,
    lse = M + log L."""
    mx = parts[0][1]
    for _, m, _ in parts[1:]:
        mx = torch.maximum(mx, m)
    o, l = 0.0, 0.0
    for op, m, lp in parts:
        w = torch.exp(m - mx)
        l = l + lp * w
        o = o + op * w.transpose(1, 2)[..., None]
    return o / l.transpose(1, 2)[..., None], mx + torch.log(l)


def flash_lse_split_reference(q, k, v, *, causal: bool = True, parts: int = 1):
    """Plain version of K2a's fp32 kernel as it computes: each query tile's
    visible key range cut into ``parts`` parts (``lse_f32_parts_reference``),
    merged in part order (``merge_lse_parts``). Returns (o (B, Tq, H, hs)
    fp32, lse (B, H, Tq) fp32), the function of flash_attention_reference."""
    b, tq, h, hs = q.shape
    o = torch.empty((b, tq, h, hs), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    for rows, pts in lse_f32_parts_reference(q, k, v, causal=causal, parts=parts):
        o[:, rows], lse[..., rows] = merge_lse_parts(pts)
    return o, lse


@functools.lru_cache(maxsize=None)
def _lse_f32_slots(device_index: int) -> int:
    """The split kernel's blocks resident at once on a card (SMs x blocks an
    SM, from the occupancy calculator)."""
    lib = _build.load()
    with torch.cuda.device(device_index):
        n = lib.gpt2vl_flash_lse_fwd_f32_slots()
    if n <= 0:
        raise RuntimeError("flash_lse_fwd_f32: the occupancy calculator failed")
    return n


def flash_lse_forward_f32(q, k, v, *, causal: bool = True):
    """Forward with logsumexp on fp32 operands (K2a's function), (o
    (B, Tq, H, hs) fp32, lse (B, H, Tq) fp32): the kernel of
    csrc/flash_lse_fwd_f32.cu for CUDA tensors, its query tiles' key ranges
    split into ``lse_f32_parts`` parts (a workspace of (items, 128, hs + 2)
    fp32 where there are several, merged in a fixed order: bit-equal run to
    run); the plain version for CPU tensors."""
    if not q.is_cuda:
        return flash_attention_with_lse_reference(q, k, v, causal=causal)
    for name, a in (("q", q), ("k", k), ("v", v)):
        _check_f32_operand(name, a)
    b, tq, h, hs = q.shape
    tk = k.shape[1]
    parts = lse_f32_parts(b * h, tq, tk, causal, _lse_f32_slots(q.device.index))
    o = torch.empty((b, tq, h, hs), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    items = -(-tq // LSE_F32_ROWS) * parts * b * h
    ws = (torch.empty(items * LSE_F32_ROWS * (hs + 2), dtype=torch.float32, device=q.device)
          if parts > 1 else None)
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.gpt2vl_flash_lse_fwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            None if ws is None else ws.data_ptr(), b, tq, tk, h, hs, *_strides(q, k, v),
            int(causal), parts, _stream(q),
        )
    _build.check(err, "flash_lse_fwd_f32")
    flash_lse_forward_f32.launches += 1
    return o, lse


flash_lse_forward_f32.launches = 0


def flash_fused_backward(q, k, v, do, lse, dcap, *, causal: bool = True):
    """(dq, dk, dv) in one pass from lse and dcap = D - dlse (both (B, H, Tq)
    fp32) and a contiguous do: the kernel for CUDA tensors, the plain version
    for CPU tensors. The kernel sums dq over the key tiles with reductions in
    global memory, in no fixed order: dq can differ in its last bits between
    two runs."""
    if not q.is_cuda:
        return flash_fused_backward_reference(q, k, v, do, lse, dcap, causal=causal)
    tail = _general_bwd_args(q, k, v, do, lse, dcap, causal)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dq_acc = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = (torch.empty(k.shape, dtype=k.dtype, device=k.device) for _ in range(2))
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.gpt2vl_flash_fused_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            dcap.data_ptr(), dq_acc.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *tail,
        )
    _build.check(err, "flash_fused_bwd")
    flash_fused_backward.launches += 1
    return dq, dk, dv


flash_fused_backward.launches = 0


def flash_fused_backward_f32(q, k, v, do, lse, dcap, *, causal: bool = True):
    """(dq, dk, dv) on fp32 operands (K3c's function) from lse and dcap = D -
    dlse (both (B, H, Tq) fp32) and a contiguous do: the kernel of
    csrc/flash_general_bwd_f32.cu, which takes the row term as an input, for
    CUDA tensors (no atomics: dq too is bit-equal run to run); the plain
    version for CPU tensors."""
    if not q.is_cuda:
        return flash_fused_backward_reference(q, k, v, do, lse, dcap, causal=causal)
    out = _f32_backward("flash_fused_bwd_f32", q, k, v, do, lse, dcap, causal)
    flash_fused_backward_f32.launches += 1
    return out


flash_fused_backward_f32.launches = 0


class _FlashAttnLse(torch.autograd.Function):
    """Forward and backward of the lse family, differentiable in o and in
    lse; saves (q, k, v, o, lse). The backward forms D with flash_rowdot,
    subtracts the cotangent of lse in plain torch (XLA code in the JAX
    package too) and hands dcap to the one-pass kernel. On CUDA tensors fp32
    q goes to the fp32 kernels, anything else to the bf16 ones."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        if q.is_cuda and q.dtype == torch.float32:
            o, lse = flash_lse_forward_f32(q, k, v, causal=causal)
        else:
            o, lse = flash_lse_forward(q, k, v, causal=causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        do = torch.zeros_like(o) if do is None else do.contiguous()
        dcap = flash_rowdot(do, o)
        if dlse is not None:
            dcap = (dcap - dlse.float()).contiguous()
        fused = (flash_fused_backward_f32 if q.is_cuda and q.dtype == torch.float32
                 else flash_fused_backward)
        dq, dk, dv = fused(q, k, v, do, lse, dcap, causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention_with_lse(q, k, v, *, causal: bool = True):
    """Attention over q (B, Tq, H, hs) and k, v (B, Tk, H, hs) that also
    returns the per-row logsumexp: (out in q.dtype, lse (B, H, Tq) fp32),
    differentiable in BOTH. The ingredient for merging attention over chunks
    of keys: given per-chunk (out_c, lse_c) the exact total is
    sum_c out_c * exp(lse_c - logaddexp_c lse_c) (ops/ring_attention.py).

    Causal masking is right-aligned and needs Tq <= Tk. CUDA tensors go to
    the lse-forward and one-pass backward kernels (bf16 or fp32, head size
    64, hs contiguous; strided views welcome) and anything they do not take
    raises; CPU tensors go to the plain versions.
    """
    _check(q, k, v, causal)
    return _FlashAttnLse.apply(q, k, v, causal)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------


def select_family(tq: int, tk: int, stream_kv: bool | None = None) -> str:
    """"self" (the Tq == Tk kernels), "general" (the streamed-K/V kernels) or
    "lse" (the lse forward and the one-pass backward) for a shape.
    stream_kv=None picks by shape: Tq == Tk up to K1_MAX_T goes to the
    self-attention kernels, everything else to the general ones; True forces
    the general kernels; False asks for the kernels that the JAX package runs
    with K/V held whole: the self-attention family on its shapes, the lse
    family (with a zero lse cotangent) on every other, as ``_flash`` there
    does with stream_kv=False (:1152-1160)."""
    self_ok = tq == tk and tq <= K1_MAX_T
    if stream_kv is None:
        return "self" if self_ok else "general"
    if stream_kv:
        return "general"
    return "self" if self_ok else "lse"


_FAMILIES = {"self": _FlashAttn, "general": _FlashAttnGeneral, "lse": _FlashAttnLse}


def flash_attention(q, k, v, *, causal: bool = True, layout: str = "bthd",
                    return_lse: bool = False, stream_kv: bool | None = None):
    """Flash attention over q (B, Tq, H, hs) and k, v (B, Tk, H, hs) with
    layout="bthd", or (B, H, T, hs) with layout="bhtd"; the output comes back
    in the same layout. With return_lse, also the per-row logsumexp
    (B, H, Tq) fp32. Tq and Tk may differ and need no alignment; causal
    masking is right-aligned (query i sees keys <= i + Tk - Tq) and needs
    Tq <= Tk. ``stream_kv`` is select_family's: None picks the kernel family
    by shape.

    CUDA tensors go to the kernels (bf16 or fp32 in every family, head size
    64, hs contiguous) and anything they do not take raises; CPU tensors go
    to the plain versions.
    Differentiable in q, k and v (not in lse).
    """
    if layout not in ("bthd", "bhtd"):
        raise ValueError(f"flash_attention: unknown layout {layout!r}")
    if layout == "bhtd":
        q, k, v = (a.transpose(1, 2) for a in (q, k, v))
    _check(q, k, v, causal)
    family = select_family(q.shape[1], k.shape[1], stream_kv)
    o, lse = _FAMILIES[family].apply(q, k, v, causal)
    if family == "lse":
        lse = lse.detach()  # flash_attention's lse carries no gradient
    if layout == "bhtd":
        o = o.transpose(1, 2)
    return (o, lse) if return_lse else o


flash_attention.launches = 0
