"""A/B: dt-layout flash attention (forward and backward) against the shipping
kernels, on an NVIDIA GPU.

Counterpart of tools/ab_dt_flash.py. There the hypothesis was a TPU one: the
shipping kernel's (block, hs=64) tiles fill half of a 128-lane register tile,
and a transposed "dt" layout, q/k/v/o as (H, hs, B*T) with the sequence
contiguous, fills it whole. A GPU has no such tile: a 64-wide bf16 row is one
full 128-byte line either way. The question that is left on this card is
coalescing along the sequence against along the head: the shipping kernels
(csrc/flash_fwd.cu, csrc/flash_bwd.cu) read (B, T, H, hs) through strides,
128 contiguous bytes of the head per position, and the dt kernels
(csrc/flash_dt_fwd.cu, csrc/flash_dt_bwd.cu) read 128 contiguous bytes of the
sequence per channel and feed the tensor cores transposed fragments. On the
TPU the QKV projection can emit the dt layout for free; here it is a copy, and
the tool times that copy on its own line. It reports the three numbers and
decides nothing. On fp32 operands (``--dtype fp32``) side A is the fp32
self-attention pair (csrc/flash_fwd_f32.cu, csrc/flash_bwd_f32.cu) and side B
the fp32 dt kernels (csrc/flash_dt_fwd_f32.cu, csrc/flash_dt_bwd_f32.cu), all
four FFMAs on the CUDA cores.

  q (H, hs, B*Tq) pre-scaled by 1/sqrt(hs); k, v (H, hs, B*Tk); one slab of T
  positions per batch row; causal means query i sees keys <= i.
  forward:  o (H, hs, B*Tq) in q's dtype, lse (H, B*Tq) fp32
  backward: dq (times dq_scale), dk, dv from dO, lse and
            dcap = rowsum(dO * O), (H, B*Tq) fp32

The TPU kernels return lse as (H, 8, B*Tq), one row replicated over eight
sublanes; here it is the one row. Their ``bq``/``bk`` arguments size VMEM
blocks; the CUDA kernels' 64-position tiles are their own constants, so
shapes must be multiples of 64.

``flash_fwd_dt_b`` and ``flash_bwd_dt_b`` launch the kernels for CUDA tensors,
routed by dtype: all bf16 to csrc/flash_dt_fwd.cu and csrc/flash_dt_bwd.cu,
all fp32 to csrc/flash_dt_fwd_f32.cu and csrc/flash_dt_bwd_f32.cu, anything
else refused; they run the plain versions ``flash_fwd_dt_b_reference`` and
``flash_bwd_dt_b_reference`` for CPU tensors. Nothing falls back from one to
the other. Each launch adds one to its kernel's counter:
``flash_fwd_dt_b.launches`` / ``flash_bwd_dt_b.launches`` for the bf16
kernels, ``.launches_f32`` beside them for the fp32 ones, and
``flash_fwd_dt_b.launches_f32_merge`` for each fp32 forward that also
launched its merge kernel (a query tile cut into several parts).

Usage (on the card; ``--dtype bf16|fp32``, bf16 by default):
  python -m gpt2_vision_language_tpu_torch.tools.ab_dt_flash [--bwd] [--iters 12]
Numerics (kernels on the card; ``--device cpu`` runs the plain versions;
``--dtype fp32|bf16``, fp32 by default: the TPU tool's own check dtype,
inputs and limits):
  python -m gpt2_vision_language_tpu_torch.tools.ab_dt_flash --check | --check-bwd
"""

from __future__ import annotations

import argparse
import functools

import numpy as np
import torch

from .. import _build
from ..ops.flash_attention import (
    LSE_F32_MAX_PARTS, flash_attention, flash_attention_reference, split_makespan,
)

TILE = 64  # positions per tile of the CUDA kernels
F32_ROWS = 128  # query rows of a block of the fp32 forward (csrc/flash_f32.cuh FWD_BQ)
HEAD_SIZE = 64
# the dtypes the dt kernels take, by the name --dtype gives them
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
KERNEL_DTYPES = {v: k for k, v in DTYPES.items()}


def to_dt(x):
    """(B, T, H, hs) -> dt layout (H, hs, B*T), b-major slabs along the last
    axis; a copy."""
    b, t, h, hs = x.shape
    return x.permute(2, 3, 0, 1).contiguous().view(h, hs, b * t)


def from_dt(x, b: int, t: int):
    """dt layout (H, hs, B*T) -> (B, T, H, hs), a strided view."""
    h, hs, _ = x.shape
    return x.reshape(h, hs, b, t).permute(2, 3, 0, 1)


def _scores(q, k, b, tq, tk, causal):
    h, hs, _ = q.shape
    s = torch.einsum("hdbq,hdbk->hbqk", q.float().reshape(h, hs, b, tq),
                     k.float().reshape(h, hs, b, tk))
    if causal:
        qpos = torch.arange(tq, device=q.device)[:, None]
        kpos = torch.arange(tk, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, float("-inf"))
    return s


def flash_fwd_dt_b_reference(q, k, v, b, tq, tk, *, causal=True):
    """Plain version of the dt forward on dt-layout tensors: fp32 scores and
    softmax, the probabilities rounded to v.dtype before the P V product as
    in the kernel. Returns (o (H, hs, B*Tq) in q.dtype, lse (H, B*Tq) fp32).
    The row statistic lse is summed in fp64 and rounded once: fp32
    ``torch.logsumexp`` on the CPU was seen up to 4.8e-5 off in the rows
    one intra-op thread computed in a process's first call, where its other
    calls and the fp64 sum agree within 5e-7."""
    h, hs, _ = q.shape
    s = _scores(q, k, b, tq, tk, causal)
    lse = torch.logsumexp(s.double(), dim=-1).float()  # (H, B, Tq)
    p = torch.exp(s - lse[..., None]).to(v.dtype).float()
    o = torch.einsum("hbqk,hdbk->hdbq", p, v.float().reshape(h, hs, b, tk))
    return o.reshape(h, hs, b * tq).to(q.dtype), lse.reshape(h, b * tq)


def dt_f32_visible_tiles(tq: int, tk: int, causal: bool) -> list[int]:
    """The key tiles each 128-row query tile of P1 fp32 sweeps
    (csrc/flash_f32.cuh visible_key_tiles, Case::DT): every one, or under the
    mask without offset those up to its last row, all of them for a tile
    past Tk."""
    ntk = -(-tk // TILE)
    return [min(-(-min(qt * F32_ROWS + F32_ROWS, tq) // TILE), ntk) if causal else ntk
            for qt in range(-(-tq // F32_ROWS))]


# What cutting P1 fp32's query tiles costs beside the schedule, in key tiles
# of one resident slot: each item of a tile of several parts writes its o, m
# and l to the workspace and the merge reads them back (DT_F32_MERGE_ITEM, the
# slots sharing that traffic), and the merge is a second launch
# (DT_F32_MERGE_LAUNCH). Fitted to the parts A/B of `chip_smoke.py
# --flash-times` (P1 fp32 with 1 to 8 parts forced at nine shapes) on an
# NVIDIA H100 80GB HBM3, where a key tile takes a slot about 12.8 us: the
# count of least cost read within 1.1% of the fastest at each shape.
DT_F32_MERGE_ITEM = 0.5
DT_F32_MERGE_LAUNCH = 0.5


def dt_f32_cost(bh: int, tq: int, tk: int, causal: bool, slots: int, parts: int) -> float:
    """P1 fp32's time in key tiles of one resident slot with ``parts`` parts
    a query tile: the list schedule's makespan over the ``slots`` resident
    blocks (``ops.flash_attention.split_makespan`` over the dt case's visible
    tiles) and, with more than one part, the merge's share."""
    _, span, split = split_makespan(bh, dt_f32_visible_tiles(tq, tk, causal), slots, parts)
    return span + (split * DT_F32_MERGE_ITEM / slots + DT_F32_MERGE_LAUNCH if parts > 1 else 0)


@functools.lru_cache(maxsize=256)
def dt_f32_parts(bh: int, tq: int, tk: int, causal: bool, slots: int) -> int:
    """Parts a query tile of P1 fp32: the count up to LSE_F32_MAX_PARTS of
    least ``dt_f32_cost``, the fewest of equal cost; 1 where the
    one-dimensional grid already fills the card's waves."""
    return min(range(1, LSE_F32_MAX_PARTS + 1),
               key=lambda p: (dt_f32_cost(bh, tq, tk, causal, slots, p), p))


def dt_f32_parts_reference(q, k, v, b, tq, tk, *, causal, parts):
    """Plain version of P1 fp32's items on dt-layout tensors: for each 128-row
    query tile, its rows and, in part order, each part's (o before the
    division by its row sum (H, hs, B, rows), running max m (H, B, rows), row
    sum l (H, B, rows)) over its key tiles, parts of at most
    ceil(max visible / parts) tiles, fp32; a row that sees none of a part's
    keys has m = -1e30 and l = 0, as in the kernel."""
    h, hs, _ = q.shape
    visible = dt_f32_visible_tiles(tq, tk, causal)
    chunk = -(-max(visible) // parts)
    s = _scores(q, k, b, tq, tk, causal)  # (H, B, Tq, Tk)
    v4 = v.float().reshape(h, hs, b, tk)
    for qt, n in enumerate(visible):
        rows = slice(qt * F32_ROWS, min(qt * F32_ROWS + F32_ROWS, tq))
        out = []
        for p in range(parts):
            if p * chunk >= n:
                break
            keys = slice(p * chunk * TILE, min((p * chunk + chunk) * TILE, tk))
            sp = s[:, :, rows, keys]
            m = sp.amax(-1).clamp_min(-1e30)
            e = torch.exp(sp - m[..., None])
            out.append((torch.einsum("hbqk,hdbk->hdbq", e, v4[..., keys]), m, e.sum(-1)))
        yield rows, out


def merge_dt_parts(parts):
    """(o (H, hs, B, rows), lse (H, B, rows)) of a query tile from its parts
    (``dt_f32_parts_reference``), merged in their order as P1 fp32's merge
    kernel does: M = max m, L = sum l exp(m - M), o = sum o exp(m - M) / L,
    lse = M + log L."""
    mx = parts[0][1]
    for _, m, _ in parts[1:]:
        mx = torch.maximum(mx, m)
    o, l = 0.0, 0.0
    for op, m, lp in parts:
        w = torch.exp(m - mx)
        l = l + lp * w
        o = o + op * w[:, None]
    return o / l[:, None], mx + torch.log(l)


def flash_fwd_dt_split_reference(q, k, v, b, tq, tk, *, causal=True, parts=1):
    """Plain version of P1 fp32 as it computes: each query tile's visible key
    range cut into ``parts`` parts (``dt_f32_parts_reference``), merged in part
    order (``merge_dt_parts``). Returns (o (H, hs, B*Tq), lse (H, B*Tq)),
    fp32, the function of ``flash_fwd_dt_b_reference``."""
    h, hs, _ = q.shape
    o = torch.empty((h, hs, b, tq), dtype=torch.float32, device=q.device)
    lse = torch.empty((h, b, tq), dtype=torch.float32, device=q.device)
    for rows, pts in dt_f32_parts_reference(q, k, v, b, tq, tk, causal=causal, parts=parts):
        o[..., rows], lse[..., rows] = merge_dt_parts(pts)
    return o.reshape(h, hs, b * tq), lse.reshape(h, b * tq)


def flash_bwd_dt_b_reference(q, k, v, do, lse, dcap, b, tq, tk, *, causal=True,
                             dq_scale=1.0):
    """Plain version of the dt one-pass backward: (dq * dq_scale, dk, dv) in
    dt layout from lse and dcap (H, B*Tq). P and dS are rounded to the
    operands' dtype before their products, as in the kernel."""
    h, hs, _ = q.shape
    q4, do4 = (a.float().reshape(h, hs, b, tq) for a in (q, do))
    k4, v4 = (a.float().reshape(h, hs, b, tk) for a in (k, v))
    s = _scores(q, k, b, tq, tk, causal)
    p = torch.exp(s - lse.reshape(h, b, tq, 1))
    dv = torch.einsum("hbqk,hdbq->hdbk", p.to(do.dtype).float(), do4)
    dp = torch.einsum("hdbq,hdbk->hbqk", do4, v4)
    ds = (p * (dp - dcap.reshape(h, b, tq, 1))).to(q.dtype).float()
    dk = torch.einsum("hbqk,hdbq->hdbk", ds, q4)
    dq = torch.einsum("hbqk,hdbk->hdbq", ds, k4) * dq_scale
    return (dq.reshape(h, hs, b * tq).to(q.dtype), dk.reshape(h, hs, b * tk).to(k.dtype),
            dv.reshape(h, hs, b * tk).to(v.dtype))


def _check_dt(name, a, h, hs, n):
    if a.shape != (h, hs, n):
        raise ValueError(f"dt layout: {name} must be (H, hs, B*T) = {(h, hs, n)}, "
                         f"got {tuple(a.shape)}")


def _check_kernel(tensors, stats, tq, tk):
    """Refuse what the dt kernels do not take; returns the operands' dtype,
    bf16 or fp32, which picks the kernel."""
    dtype = tensors[0][1].dtype
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f"dt kernel takes bf16 or fp32 operands, got {tensors[0][0]} {dtype}")
    for name, a in tensors:
        if a.dtype != dtype or not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError(f"dt kernel takes contiguous 16-byte aligned operands of one "
                             f"dtype ({KERNEL_DTYPES[dtype]}), got {name} {a.dtype} strides "
                             f"{a.stride()}")
    for name, a in stats:
        if a.dtype != torch.float32 or not a.is_contiguous():
            raise ValueError(f"dt kernel takes contiguous fp32 {name}, got {a.dtype}")
    if tensors[0][1].shape[1] != HEAD_SIZE:
        raise ValueError(f"dt kernel: head size {tensors[0][1].shape[1]} is not {HEAD_SIZE}")
    if tq % TILE or tk % TILE:
        raise ValueError(f"dt kernel: aligned shapes only, Tq and Tk multiples of {TILE}, "
                         f"got {tq}, {tk}")
    return dtype


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=None)
def _dt_f32_slots(device_index) -> int:
    """P1 fp32's blocks resident at once on a card (SMs x blocks an SM, from
    the occupancy calculator)."""
    lib = _build.load()
    with torch.cuda.device(device_index):
        n = lib.gpt2vl_flash_dt_fwd_f32_slots()
    if n <= 0:
        raise RuntimeError("flash_dt_fwd_f32: the occupancy calculator failed")
    return n


def flash_fwd_dt_b(q, k, v, b, tq, tk, *, causal=True):
    """dt forward: q (H, hs, B*Tq) pre-scaled, k, v (H, hs, B*Tk) ->
    (o (H, hs, B*Tq), lse (H, B*Tq) fp32). The kernel for CUDA tensors (bf16
    or fp32, by the operands' dtype), the plain version for CPU tensors. The
    fp32 kernel cuts each query tile's key range into ``dt_f32_parts``
    parts and merges them in a fixed order (``flash_fwd_dt_split_reference``
    computes as it does): bit-equal run to run."""
    h, hs, _ = q.shape
    _check_dt("q", q, h, hs, b * tq)
    _check_dt("k", k, h, hs, b * tk)
    _check_dt("v", v, h, hs, b * tk)
    if not q.is_cuda:
        if q.device.type != "cpu":
            raise ValueError(f"flash_fwd_dt_b: no kernel for device {q.device}")
        return flash_fwd_dt_b_reference(q, k, v, b, tq, tk, causal=causal)
    f32 = _check_kernel((("q", q), ("k", k), ("v", v)), (), tq, tk) == torch.float32
    o = torch.empty_like(q)
    lse = torch.empty((h, b * tq), dtype=torch.float32, device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        if f32:
            # the fp32 kernel's one-dimensional grid, each query tile's key
            # range in dt_f32_parts parts; a workspace of items x 128 x
            # (hs + 2) fp32 where there are several, merged in a fixed order
            parts = dt_f32_parts(b * h, tq, tk, causal, _dt_f32_slots(q.device.index))
            items = -(-tq // F32_ROWS) * parts * b * h
            ws = (torch.empty(items * F32_ROWS * (hs + 2), dtype=torch.float32, device=q.device)
                  if parts > 1 else None)
            err = lib.gpt2vl_flash_dt_fwd_f32(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                None if ws is None else ws.data_ptr(), b, tq, tk, h, hs, int(causal), parts,
                _stream(q))
        else:
            err = lib.gpt2vl_flash_dt_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                          lse.data_ptr(), b, tq, tk, h, hs, int(causal),
                                          _stream(q))
    _build.check(err, "flash_dt_fwd_f32" if f32 else "flash_dt_fwd")
    if f32:
        flash_fwd_dt_b.launches_f32 += 1
        flash_fwd_dt_b.launches_f32_merge += int(parts > 1)
    else:
        flash_fwd_dt_b.launches += 1
    return o, lse


flash_fwd_dt_b.launches = 0
flash_fwd_dt_b.launches_f32 = 0
flash_fwd_dt_b.launches_f32_merge = 0


def flash_bwd_dt_b(q, k, v, do, lse, dcap, b, tq, tk, *, causal=True, dq_scale=1.0):
    """dt backward: (dq * dq_scale, dk, dv) in dt layout from do (H, hs,
    B*Tq), lse and dcap (H, B*Tq) fp32. The kernel for CUDA tensors (bf16 or
    fp32, by the operands' dtype), the plain version for CPU tensors. Both
    kernels sum each of dq, dk and dv in a fixed order, as the TPU kernel
    sums dq in one scratch in key order: the bf16 one each in one block, the
    fp32 one (one pass a visible pair) dk and dv in one block and dq across
    blocks, a part per key tile added in global memory in a fixed order under
    a flag per query tile. All three are bit-equal from run to run."""
    h, hs, _ = q.shape
    _check_dt("q", q, h, hs, b * tq)
    _check_dt("do", do, h, hs, b * tq)
    _check_dt("k", k, h, hs, b * tk)
    _check_dt("v", v, h, hs, b * tk)
    if lse.shape != (h, b * tq) or dcap.shape != (h, b * tq):
        raise ValueError(f"lse and dcap must be (H, B*Tq) = {(h, b * tq)}, got "
                         f"{tuple(lse.shape)}, {tuple(dcap.shape)}")
    if not q.is_cuda:
        if q.device.type != "cpu":
            raise ValueError(f"flash_bwd_dt_b: no kernel for device {q.device}")
        return flash_bwd_dt_b_reference(q, k, v, do, lse, dcap, b, tq, tk, causal=causal,
                                        dq_scale=dq_scale)
    f32 = _check_kernel((("q", q), ("k", k), ("v", v), ("do", do)),
                        (("lse", lse), ("dcap", dcap)), tq, tk) == torch.float32
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = _build.load()
    launch = lib.gpt2vl_flash_dt_bwd_f32 if f32 else lib.gpt2vl_flash_dt_bwd
    with torch.cuda.device(q.device):
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                     dcap.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                     b, tq, tk, h, hs, int(causal), float(dq_scale), _stream(q))
    _build.check(err, "flash_dt_bwd_f32" if f32 else "flash_dt_bwd")
    if f32:
        flash_bwd_dt_b.launches_f32 += 1
    else:
        flash_bwd_dt_b.launches += 1
    return dq, dk, dv


flash_bwd_dt_b.launches = 0
flash_bwd_dt_b.launches_f32 = 0


def dcap_dt(o, do):
    """dcap = rowsum(dO * O) over the head channels, (H, B*Tq) fp32 (plain
    torch, as the TPU tool leaves it to XLA)."""
    return (o.float() * do.float()).sum(1)


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------


def _device(device):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("ab_dt_flash: no CUDA device (pass --device cpu to run "
                           "the plain versions)")
    return device


# the checks' limits by dtype: fp32 the TPU tool's own (o, and the gradients
# relative to max |ref|); bf16 about one bf16 ulp of an output of size up to
# about 4, and P and dS rounded to bf16 before their products
CHECK_LIMITS = {"fp32": (2e-5, 1e-5), "bf16": (2e-2, 3e-2)}


def _check_inputs(seed, n, device, dtype):
    """n (B, T, H, hs) tensors at the TPU tool's check shape, drawn in fp32 as
    it draws them, in ``dtype`` ("fp32", or "bf16": rounded)."""
    b, h, t, hs = 2, 3, 1024, 64
    rng = np.random.RandomState(seed)
    xs = [torch.from_numpy(rng.randn(b, h, t, hs).astype(np.float32)).transpose(1, 2)
          for _ in range(n)]
    return [x.to(device=device, dtype=DTYPES[dtype]).contiguous() for x in xs], (b, h, t, hs)


def check_numerics(device="cuda", dtype="fp32"):
    """The dt forward against the shipping path's plain reference at
    (2, 3, 1024, 64) on ``dtype`` operands: on fp32 the TPU tool's own check
    (its inputs, limit 2e-5), on bf16 limit 2e-2. The kernels on the card,
    the plain versions on the CPU."""
    device = _device(device)
    limit = CHECK_LIMITS[dtype][0]
    (q, k, v), (b, h, t, hs) = _check_inputs(0, 3, device, dtype)
    ref, _ = flash_attention_reference(q.float(), k.float(), v.float(), causal=True)
    scale = hs ** -0.5
    o_dt, lse = flash_fwd_dt_b(to_dt(q * scale), to_dt(k), to_dt(v), b, t, t, causal=True)
    got = from_dt(o_dt, b, t).float()
    err = float((got - ref).abs().max())
    print(f"dt fwd max |err| vs the shipping path's plain version: {err:.2e} "
          f"(limit {limit:.0e}, {dtype}, {device.type})")
    assert o_dt.dtype == q.dtype and err < limit, err
    assert lse.shape == (h, b * t) and bool(torch.isfinite(lse).all())
    print("OK")
    return err


def check_bwd_numerics(device="cuda", dtype="fp32"):
    """The dt forward + backward against the gradients of the shipping path's
    plain reference (autograd) at (2, 3, 1024, 64) on ``dtype`` operands,
    relative to max |ref|: on fp32 the TPU tool's own check (limit 1e-5), on
    bf16 limit 3e-2. The kernels on the card, the plain versions on the
    CPU."""
    device = _device(device)
    limit = CHECK_LIMITS[dtype][1]
    (q, k, v, dout), (b, h, t, hs) = _check_inputs(1, 4, device, dtype)
    q32, k32, v32 = (a.float().clone().requires_grad_() for a in (q, k, v))
    o_ref, _ = flash_attention_reference(q32, k32, v32, causal=True)
    refs = torch.autograd.grad((o_ref * dout.float()).sum(), (q32, k32, v32))
    scale = hs ** -0.5
    qs, kd, vd, dod = to_dt(q * scale), to_dt(k), to_dt(v), to_dt(dout)
    o, lse = flash_fwd_dt_b(qs, kd, vd, b, t, t, causal=True)
    dq, dk, dv = flash_bwd_dt_b(qs, kd, vd, dod, lse, dcap_dt(o, dod), b, t, t, causal=True,
                                dq_scale=scale)
    rels = {}
    for name, got, ref in (("dq", dq, refs[0]), ("dk", dk, refs[1]), ("dv", dv, refs[2])):
        err = float((from_dt(got, b, t).float() - ref).abs().max())
        rels[name] = err / float(ref.abs().max())
        print(f"{name}: max |err| {err:.2e} (rel {rels[name]:.2e}, limit {limit:.0e}, {dtype})")
        assert got.dtype == q.dtype and rels[name] < limit, (name, err)
    print("OK")
    return rels


# ---------------------------------------------------------------------------
# Device A/B
# ---------------------------------------------------------------------------


def _time_ms(fn, iters: int) -> float:
    """Device ms per call by CUDA events over ``iters`` calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bench_inputs(device, seed=0, dtype="bf16"):
    """The fused QKV output of one layer at the pretrain shape and an output
    cotangent: (B, T, 3C) and (B, T, H, hs) in ``dtype`` (bf16 or fp32)."""
    b, h, t, hs = 8, 12, 1024, 64
    g = torch.Generator(device).manual_seed(seed)
    qkv = torch.randn(b, t, 3 * h * hs, generator=g, device=device).to(DTYPES[dtype])
    dout = torch.randn(b, t, h, hs, generator=g, device=device).to(DTYPES[dtype])
    return qkv, dout, (b, h, t, hs)


def _report(title, rows, layers):
    print(title)
    for name, ms in rows.items():
        print(f"    {name}: {ms * layers:.3f} ms device for {layers} layers "
              f"({ms * 1000:.1f} us/layer)")
    return rows


def bench(device="cuda", layers: int = 12, dtype="bf16"):
    """Device A/B of the forward over ``layers`` calls, by CUDA events, on
    ``dtype`` operands.

    A = the shipping path: flash_attention(layout="bthd") on the strided
        views of the fused QKV output (csrc/flash_fwd.cu; on fp32 operands
        csrc/flash_fwd_f32.cu).
    B = the dt forward alone (csrc/flash_dt_fwd.cu; csrc/flash_dt_fwd_f32.cu).
    T = the copies into and out of the dt layout (q scaled, k, v in; o out),
        which the TPU projection emits for free and this port would pay.
    """
    device = _device(device)
    if device.type != "cuda":
        raise RuntimeError("ab_dt_flash bench measures device time: it needs a CUDA device")
    qkv, _, (b, h, t, hs) = _bench_inputs(device, dtype=dtype)
    q, k, v = (a.view(b, t, h, hs) for a in qkv.split(h * hs, dim=-1))
    scale = hs ** -0.5
    qd, kd, vd = to_dt(q * scale), to_dt(k), to_dt(v)
    with torch.no_grad():
        o_dt, _ = flash_fwd_dt_b(qd, kd, vd, b, t, t, causal=True)
        rows = {
            "A bthd (shipping forward)": _time_ms(
                lambda: flash_attention(q, k, v, causal=True, layout="bthd"), layers),
            "B dt forward": _time_ms(
                lambda: flash_fwd_dt_b(qd, kd, vd, b, t, t, causal=True), layers),
            "T transposes (q*scale, k, v in; o out)": _time_ms(
                lambda: (to_dt(q * scale), to_dt(k), to_dt(v),
                         from_dt(o_dt, b, t).contiguous()), layers),
        }
    return _report(f"forward, B={b} T={t} H={h} hs={hs} {dtype} causal, "
                   f"{torch.cuda.get_device_name(device)}", rows, layers)


def bench_bwd(device="cuda", layers: int = 12, dtype="bf16"):
    """Device A/B of forward + backward over ``layers`` calls, by CUDA events,
    on ``dtype`` operands.

    A = the shipping path through autograd: flash_attention(layout="bthd") on
        the strided QKV views and its backward (csrc/flash_fwd.cu,
        csrc/flash_bwd.cu; on fp32 operands the fp32 pair,
        csrc/flash_fwd_f32.cu, csrc/flash_bwd_f32.cu).
    B = dt forward + dcap + dt one-pass backward (csrc/flash_dt_fwd.cu,
        csrc/flash_dt_bwd.cu; csrc/flash_dt_fwd_f32.cu,
        csrc/flash_dt_bwd_f32.cu).
    T = the copies into and out of the dt layout (q scaled, k, v, dO in;
        o, dq, dk, dv out).
    """
    device = _device(device)
    if device.type != "cuda":
        raise RuntimeError("ab_dt_flash bench measures device time: it needs a CUDA device")
    qkv, dout, (b, h, t, hs) = _bench_inputs(device, dtype=dtype)
    qkv.requires_grad_()
    scale = hs ** -0.5

    def path_a():
        q, k, v = (a.view(b, t, h, hs) for a in qkv.split(h * hs, dim=-1))
        o = flash_attention(q, k, v, causal=True, layout="bthd")
        qkv.grad = None
        o.backward(dout)

    with torch.no_grad():
        q, k, v = (a.view(b, t, h, hs) for a in qkv.detach().split(h * hs, dim=-1))
        qd, kd, vd, dod = to_dt(q * scale), to_dt(k), to_dt(v), to_dt(dout)

    def path_b():
        o, lse = flash_fwd_dt_b(qd, kd, vd, b, t, t, causal=True)
        return (o,) + flash_bwd_dt_b(qd, kd, vd, dod, lse, dcap_dt(o, dod), b, t, t,
                                     causal=True, dq_scale=scale)

    with torch.no_grad():
        outs = path_b()

    def transposes():
        ins = (to_dt(q * scale), to_dt(k), to_dt(v), to_dt(dout))
        return ins, tuple(from_dt(a, b, t).contiguous() for a in outs)

    rows = {"A bthd grad (shipping forward + backward)": _time_ms(path_a, layers)}
    with torch.no_grad():
        rows["B dt forward + backward"] = _time_ms(path_b, layers)
        rows["T transposes (q*scale, k, v, dO in; o, dq, dk, dv out)"] = _time_ms(
            transposes, layers)
    return _report(f"forward + backward, B={b} T={t} H={h} hs={hs} {dtype} causal, "
                   f"{torch.cuda.get_device_name(device)}", rows, layers)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--check-bwd", action="store_true")
    ap.add_argument("--bwd", action="store_true")
    ap.add_argument("--iters", type=int, default=12, help="layers per timed loop")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cpu runs the plain versions of the checks")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default=None,
                    help="the operands' dtype: the checks default to fp32 (the TPU tool's "
                         "check dtype and limits), the benches to bf16")
    args = ap.parse_args(argv)
    check_dtype, bench_dtype = args.dtype or "fp32", args.dtype or "bf16"
    if args.check:
        return check_numerics(args.device, check_dtype)
    if args.check_bwd:
        return check_bwd_numerics(args.device, check_dtype)
    if args.bwd:
        return bench_bwd(args.device, args.iters, bench_dtype)
    return bench(args.device, args.iters, bench_dtype)


if __name__ == "__main__":
    main()
