"""Ring attention: causal attention over a sequence cut into chunks, every
(query chunk, key chunk) pair computed on its own and the partial results
merged exactly.

Counterpart of gpt2_vision_language_tpu/ops/ring_attention.py, same names.
Rank ``my`` of a ring of ``n`` holds query chunk ``my``; K/V chunks travel
around the ring, and at hop ``h`` the rank holds chunk ``src = (my - h) % n``:

  * src == my : the chunk's own causal attention;
  * src <  my : an earlier chunk, fully visible, no mask;
  * src >  my : a later chunk, contributes nothing and launches nothing.

Each visible pair gives a normalized partial output and its logsumexp
(``_chunk_attn_flash``: ops/flash_attention.flash_attention_with_lse, the lse
forward and one-pass backward kernels on a CUDA device; or
``_chunk_attn_einsum``, the dense reference), and ``_merge`` combines two
partials with the usual flash rescaling, so the result is exactly softmax over
the whole sequence up to fp32 summation order. The partial output stays fp32
through every merge and is cast to q.dtype once; a rank's first partial (its
own chunk at hop 0) starts the carry as it is. Gradients flow through the
merges by plain autograd and reach the chunk kernels as a cotangent of the
output and one of the logsumexp.

``_ring_body`` is the per-rank program, written once against a small handle
that gives ``rank``, ``size``, ``rotate(k, v)`` and ``tie(out, k, v)``. Two
kinds of ring supply it:

  * ``LocalRing(n)``: one process. ``ring_attention`` takes GLOBAL tensors
    (B, T, H, hs), T divisible by n, and runs the n ranks in turn over views
    of the n chunks (no copies: the kernels read through strides); ``rotate``
    is an index shift. This is what the trainer uses on one device.
  * ``GroupRing(group)``: one process per rank over a ``torch.distributed``
    process group. ``ring_attention`` takes the rank's LOCAL chunk and returns
    the local chunk of the output; ``rotate`` sends K/V to rank r + 1 and
    receives from r - 1, and its backward sends the cotangents the other way
    (the transpose of the JAX package's ``ppermute``, :136-138 there).

``set_ring`` installs the ring that ``ops.attention.sdpa(impl="ring")`` reads,
as ``set_ring_mesh`` / ``RING_MESH`` do in the JAX package (:44-50).
"""

from __future__ import annotations

import torch

from .flash_attention import flash_attention_with_lse

NEG_INF = -1e30

# the ring consumed by ops.attention.sdpa(impl="ring"), so the model's
# attn_impl flag selects the ring path without a ring argument on every layer
RING = None


def set_ring(ring) -> None:
    """Install (or with None remove) the ring of sdpa(impl="ring"): a
    LocalRing, a GroupRing, or an int n for LocalRing(n)."""
    global RING
    RING = LocalRing(ring) if isinstance(ring, int) else ring


class LocalRing:
    """A ring of ``size`` ranks run in turn by one process over the chunks of
    global tensors."""

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"ring size must be at least 1, got {size}")
        self.size = int(size)


class _LocalRank:
    """Rank ``rank`` of a LocalRing: holds views of every K/V chunk, and a
    rotation hands it the chunk of the rank before the current owner."""

    def __init__(self, rank: int, ks, vs):
        self.rank, self.size = rank, len(ks)
        self._ks, self._vs, self._held = ks, vs, rank

    def rotate(self, k, v):
        self._held = (self._held - 1) % self.size
        return self._ks[self._held], self._vs[self._held]

    def tie(self, out, k, v):
        return out


class _Rotate(torch.autograd.Function):
    """Send K and V to the next rank and receive the previous rank's; the
    backward sends the cotangents to the previous rank and receives the next
    rank's."""

    @staticmethod
    def forward(ctx, k, v, group):
        ctx.group = group
        return _exchange((k, v), group, +1)

    @staticmethod
    def backward(ctx, dk, dv):
        return (*_exchange((dk, dv), ctx.group, -1), None)


def _exchange(tensors, group, step: int):
    """Send each tensor ``step`` ranks on around the group and return what
    arrives from ``step`` ranks back."""
    import torch.distributed as dist

    rank, n = dist.get_rank(group), dist.get_world_size(group)
    to = dist.get_global_rank(group, (rank + step) % n)
    frm = dist.get_global_rank(group, (rank - step) % n)
    sent = [t.contiguous() for t in tensors]
    got = [torch.empty_like(t) for t in sent]
    ops = [dist.P2POp(dist.isend, t, to, group) for t in sent]
    ops += [dist.P2POp(dist.irecv, t, frm, group) for t in got]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return tuple(got)


class _Tie(torch.autograd.Function):
    """out, unchanged, with an explicit zero gradient for k and v: it puts the
    last rotation into the graph of a rank that did not use its chunk, so
    that every rank runs every rotation's backward and the exchanges pair
    up."""

    @staticmethod
    def forward(ctx, out, k, v):
        ctx.save_for_backward(k, v)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, dout):
        k, v = ctx.saved_tensors
        return dout, torch.zeros_like(k), torch.zeros_like(v)


class GroupRing:
    """The ring over a ``torch.distributed`` process group (the default group
    when None): this process is rank ``rank`` of ``size`` and holds one chunk."""

    def __init__(self, group=None):
        import torch.distributed as dist

        self.group = dist.group.WORLD if group is None else group
        self.rank, self.size = dist.get_rank(self.group), dist.get_world_size(self.group)

    def rotate(self, k, v):
        return _Rotate.apply(k, v, self.group)

    def tie(self, out, k, v):
        if k.requires_grad or v.requires_grad:
            return _Tie.apply(out, k, v)
        return out


def _chunk_attn_einsum(q, k, v, *, causal, scale):
    """Per-chunk attention returning NORMALIZED (out fp32 (B, Tq, H, hs), lse
    (B, Tq, H, 1)). The dense reference (CPU tests, small chunks): it holds
    the chunk pair's whole (Tq, Tk) score matrix."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        qpos = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
        keep = qpos >= torch.arange(tk, device=q.device)[None, :]
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)  # (B, H, Tq, 1)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    lse = (m + torch.log(l)).transpose(1, 2)  # (B, Tq, H, 1)
    return out / l.transpose(1, 2), lse


def _chunk_attn_flash(q, k, v, *, causal, scale):
    """Per-chunk attention through flash_attention_with_lse: no score matrix
    per chunk pair. The kernels apply 1/sqrt(hs) themselves."""
    del scale
    out, lse = flash_attention_with_lse(q, k, v, causal=causal)
    return out.float(), lse.transpose(1, 2).unsqueeze(-1)


def _merge(carry, update):
    """Merge two normalized partials (out, lse): the exact softmax combine."""
    o0, l0 = carry
    o1, l1 = update
    l = torch.logaddexp(l0, l1)
    # exp(-inf - -inf) is nan; a chunk with l == NEG_INF contributes 0
    zero = torch.zeros((), dtype=l.dtype, device=l.device)
    w0 = torch.where(l0 <= NEG_INF, zero, torch.exp(l0 - l))
    w1 = torch.where(l1 <= NEG_INF, zero, torch.exp(l1 - l))
    return o0 * w0 + o1 * w1, l


def _ring_body(q, k, v, handle, *, scale, chunk_impl):
    """The program of one rank: fold the ring's K/V chunks into the rank's
    queries. q, k, v: the rank's chunks (B, T/n, H, hs)."""
    my, n = handle.rank, handle.size
    attn = _chunk_attn_flash if chunk_impl == "flash" else _chunk_attn_einsum
    # hop 0 holds the rank's own chunk: its causal attention starts the carry.
    # (The JAX body merges it into an empty carry, out 0 and lse NEG_INF, which
    # _merge returns unchanged; run eagerly that merge would cost a dozen
    # passes over the chunk for nothing.)
    out, lse = attn(q, k, v, causal=True, scale=scale)
    for hop in range(1, n):
        k, v = handle.rotate(k, v)
        src = (my - hop) % n  # owner of the chunk now held
        # chunk-level causality, branched so a rank does only the pairs it
        # sees: src < my -> an earlier chunk, fully visible; src > my -> a
        # later chunk, nothing to compute or merge
        if src < my:
            out, lse = _merge((out, lse), attn(q, k, v, causal=False, scale=scale))
    return handle.tie(out, k, v).to(q.dtype)


def ring_attention(q, k, v, ring, *, causal: bool = True, chunk_impl: str = "auto",
                   layout: str = "bthd"):
    """Causal attention over a sequence cut into ``ring.size`` chunks.

    With a LocalRing (or an int n): q, k, v are GLOBAL (B, T, H, hs) tensors
    (layout="bthd") or (B, H, T, hs) (layout="bhtd", the JAX function's
    order), T divisible by n; the result has the same shape. With a
    GroupRing: the LOCAL chunks of this rank in, the local chunk out.

    chunk_impl: "flash" runs each visible chunk pair through
    flash_attention_with_lse (the kernels on a CUDA device, with no score
    matrix per pair); "einsum" is the dense reference; "auto" takes flash for
    CUDA tensors with chunks of at least 512 positions, as ops.attention.sdpa
    routes plain attention.
    """
    if not causal:
        raise ValueError("non-causal ring attention is not needed by any caller")
    if layout not in ("bthd", "bhtd"):
        raise ValueError(f"ring_attention: unknown layout {layout!r}")
    if chunk_impl not in ("auto", "flash", "einsum"):
        raise ValueError(f"ring_attention: unknown chunk_impl {chunk_impl!r}")
    if isinstance(ring, int):
        ring = LocalRing(ring)
    n = ring.size
    if n == 1:
        from .attention import xla_sdpa

        return xla_sdpa(q, k, v, causal=True, layout=layout)
    if layout == "bhtd":
        q, k, v = (a.transpose(1, 2) for a in (q, k, v))
    local = isinstance(ring, LocalRing)
    if local and q.shape[1] % n:
        raise ValueError(f"ring_attention: T={q.shape[1]} is not divisible by the ring "
                         f"size {n}")
    if chunk_impl == "auto":
        chunk = q.shape[1] // n if local else q.shape[1]
        chunk_impl = "flash" if (q.is_cuda and chunk >= 512) else "einsum"
    scale = q.shape[-1] ** -0.5
    if local:
        qs, ks, vs = (a.chunk(n, dim=1) for a in (q, k, v))
        out = torch.cat([
            _ring_body(qs[r], ks[r], vs[r], _LocalRank(r, ks, vs), scale=scale,
                       chunk_impl=chunk_impl)
            for r in range(n)
        ], dim=1)
    else:
        out = _ring_body(q, k, v, ring, scale=scale, chunk_impl=chunk_impl)
    return out.transpose(1, 2) if layout == "bhtd" else out
