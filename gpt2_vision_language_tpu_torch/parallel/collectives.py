"""The collectives of the parallel styles, and the autograd Functions built on
them.

The JAX package writes no collective: GSPMD inserts them from the parameter
and activation shardings (gpt2_vision_language_tpu/parallel/mesh.py:9-12,
sharding.py:1-20). Here every one is explicit and goes through this module:

  * ``all_reduce_``, ``all_gather``, ``reduce_scatter``, ``broadcast_``,
    ``all_to_all``, ``exchange`` (the ring's send to the next rank and
    receive from the previous one) and the pipeline's point-to-point
    ``send`` and ``recv``;
  * the Megatron pair ``CopyToGroup`` (identity forward, all-reduce backward)
    and ``ReduceFromGroup`` (all-reduce forward, identity backward), the
    sequence-parallel pair ``GatherSeq`` (all-gather on T forward,
    reduce-scatter backward) and ``ScatterSeq`` (the transpose),
    ``GatherRows``, the vocab-sharded ``wte`` gathered whole for the tied
    head, and the all-to-all pair of the ring under Megatron placement,
    ``HeadsToChunks`` (this rank's heads over the whole sequence -> every
    head over this rank's chunk of it) and ``ChunksToHeads`` (its inverse),
    each the other's backward;
  * ``GradSync``: the train step's one all-reduce of the accumulated grads per
    optimizer step, flattened into one buffer a process group (the
    reference's DDP ``no_sync`` semantics), the loss averaged over ``data``,
    and the global grad norm.

Reductions run in fp32 whatever the operands' dtype (bf16 partial sums are
widened first and rounded once after), so every rank holds the same bits.
Gathers and sends move bf16 as its 16 bits.

Transport. NCCL takes CUDA tensors for everything. gloo, the backend of
ranks that share one card or run on the CPU, takes CUDA tensors in all-reduce,
all-gather, reduce-scatter and broadcast, but a send or receive of a CUDA
tensor aborts the process (probed with torch 2.11 on an H100): ``exchange``,
``send``, ``recv`` and ``all_to_all`` stage those through pinned host memory
in ``host_staged``, which counts its calls. That is the gloo transport, not a
fallback: the arithmetic stays on the card.
"""

from __future__ import annotations

import collections
import math
from typing import Dict, Iterable, Optional

import torch
import torch.distributed as dist

# calls a rank made of each collective (its recorded readings: a step's
# collectives, tools/dist_worker.py)
counts: Dict[str, int] = collections.Counter()


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _staged(group, t: torch.Tensor) -> bool:
    """A send or receive of a CUDA tensor over gloo: staged on the host."""
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def host_staged(fn, tensors):
    """Run ``fn`` on pinned host copies of ``tensors`` and return its host
    results copied back to the first tensor's device: the gloo transport of
    an operation gloo refuses on CUDA tensors. ``host_staged.calls`` counts
    the calls."""
    host_staged.calls += 1
    dev = tensors[0].device
    host = [t.detach().to("cpu").pin_memory() if t.is_cuda else t for t in tensors]
    out = fn(host)
    return [o.to(dev, non_blocking=True) for o in out]


host_staged.calls = 0


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A bf16 tensor as 16-bit halves of the same bits, for moves that do not
    compute (gloo's dtype table need not hold bf16)."""
    return t.view(torch.float16) if t.dtype == torch.bfloat16 else t


def _unbits(t: torch.Tensor, dtype) -> torch.Tensor:
    return t.view(dtype) if dtype == torch.bfloat16 else t


@torch.no_grad()
def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place, in fp32; returns ``t``."""
    if _size(group) == 1:
        return t
    counts["all_reduce"] += 1
    if t.dtype == torch.float32:
        dist.all_reduce(t, group=group)
        return t
    wide = t.float()
    dist.all_reduce(wide, group=group)
    return t.copy_(wide)


@torch.no_grad()
def all_gather(t: torch.Tensor, group, dim: int = 0, sizes=None) -> torch.Tensor:
    """The pieces of every rank of ``group`` concatenated along ``dim`` in
    rank order. ``sizes``: each rank's extent along ``dim`` where they
    differ (each piece is padded to the largest for the move)."""
    n = _size(group)
    if n == 1:
        return t
    counts["all_gather"] += 1
    dtype = t.dtype
    big = t.shape[dim] if sizes is None else max(sizes)
    x = t.movedim(dim, 0)
    if x.shape[0] < big:
        x = torch.cat([x, x.new_zeros((big - x.shape[0], *x.shape[1:]))])
    x = _bits(x.contiguous())
    out = x.new_empty((n * big, *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    parts = out.view(n, big, *x.shape[1:])
    if sizes is not None:
        parts = [parts[r, :sizes[r]] for r in range(n)]
    full = torch.cat(list(parts)) if sizes is not None else out
    return _unbits(full, dtype).movedim(0, dim)


@torch.no_grad()
def reduce_scatter(t: torch.Tensor, group, dim: int = 0, sizes=None) -> torch.Tensor:
    """This rank's piece along ``dim`` of ``t`` summed over ``group``, in
    fp32, returned in t's dtype. Even pieces by reduce-scatter; uneven ones
    (``sizes``) by an all-reduce and a slice."""
    n = _size(group)
    if n == 1:
        return t
    counts["reduce_scatter"] += 1
    r = _rank(group)
    if sizes is not None and len(set(sizes)) > 1:
        full = all_reduce_(t.clone(), group)
        start = sum(sizes[:r])
        return full.narrow(dim, start, sizes[r])
    x = t.movedim(dim, 0).float().contiguous()
    out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=group)
    return out.to(t.dtype).movedim(0, dim)


@torch.no_grad()
def broadcast_(t: torch.Tensor, group, src: int) -> torch.Tensor:
    """``t`` of rank ``src`` of ``group`` on every rank, in place (``t``
    contiguous); returns ``t``."""
    if _size(group) > 1:
        counts["broadcast"] += 1
        dist.broadcast(_bits(t), dist.get_global_rank(group, src), group=group)
    return t


def all_to_all(pieces, group, shapes):
    """Send ``pieces[j]`` to rank j of ``group`` and return what every rank j
    sent this one, as tensors of ``shapes[j]`` (one dtype and device, any
    sizes, empty ones too): one ``all_to_all_single`` over flat buffers."""
    counts["all_to_all"] += 1
    dtype = pieces[0].dtype
    send = _bits(torch.cat([p.reshape(-1) for p in pieces]))
    sizes_in = [p.numel() for p in pieces]
    sizes_out = [math.prod(s) for s in shapes]

    def move(ts):
        got = ts[0].new_empty(sum(sizes_out))
        dist.all_to_all_single(got, ts[0], sizes_out, sizes_in, group=group)
        return [got]

    got = host_staged(move, [send])[0] if _staged(group, send) else move([send])[0]
    got = _unbits(got, dtype)
    return [part.view(s) for part, s in zip(got.split(sizes_out), shapes)]


def heads_to_chunks(x: torch.Tensor, group, heads) -> torch.Tensor:
    """(B, T, ..., heads[r], hs) of rank r's heads over the whole sequence ->
    (B, T / n, ..., sum(heads), hs): every head over rank r's chunk of T,
    positions r * T / n on, heads in rank order."""
    n, t = _size(group), x.shape[1]
    tc = t // n
    pieces = [x[:, j * tc:(j + 1) * tc] for j in range(n)]
    shapes = [(x.shape[0], tc, *x.shape[2:-2], h, x.shape[-1]) for h in heads]
    return torch.cat(all_to_all(pieces, group, shapes), dim=-2)


def chunks_to_heads(y: torch.Tensor, group, heads) -> torch.Tensor:
    """The inverse of ``heads_to_chunks``: (B, T / n, ..., sum(heads), hs) of
    rank r's chunk -> (B, T, ..., heads[r], hs) of its heads."""
    n, r = _size(group), _rank(group)
    pieces = list(y.split(list(heads), dim=-2))
    shape = (y.shape[0], y.shape[1], *y.shape[2:-2], heads[r], y.shape[-1])
    return torch.cat(all_to_all(pieces, group, [shape] * n), dim=1)


def exchange(tensors, group, step: int):
    """Send each tensor ``step`` ranks on around ``group`` and return what
    arrives from ``step`` ranks back (the ring's rotation)."""
    counts["exchange"] += 1
    rank, n = dist.get_rank(group), dist.get_world_size(group)
    to = dist.get_global_rank(group, (rank + step) % n)
    frm = dist.get_global_rank(group, (rank - step) % n)
    sent = [t.contiguous() for t in tensors]
    dtypes = [t.dtype for t in sent]

    def move(ts):
        ts = [_bits(t) for t in ts]
        got = [torch.empty_like(t) for t in ts]
        ops = [dist.P2POp(dist.isend, t, to, group) for t in ts]
        ops += [dist.P2POp(dist.irecv, t, frm, group) for t in got]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return got

    got = host_staged(move, sent) if _staged(group, sent[0]) else move(sent)
    return tuple(_unbits(g, d) for g, d in zip(got, dtypes))


def send(t: torch.Tensor, group, peer: int) -> None:
    """Send ``t`` to rank ``peer`` of ``group`` (returns when it is sent)."""
    counts["send"] += 1
    dst = dist.get_global_rank(group, peer)
    x = _bits(t.detach().contiguous())

    def move(ts):
        dist.send(ts[0], dst, group=group)
        return []

    if _staged(group, x):
        host_staged(move, [x])
    else:
        move([x])


def recv(like: torch.Tensor, group, peer: int) -> torch.Tensor:
    """A tensor of ``like``'s shape, dtype and device received from rank
    ``peer`` of ``group``."""
    counts["recv"] += 1
    src = dist.get_global_rank(group, peer)
    buf = _bits(torch.empty_like(like, memory_format=torch.contiguous_format))

    def move(ts):
        dist.recv(ts[0], src, group=group)
        return [ts[0]]

    got = host_staged(move, [buf])[0] if _staged(group, buf) else move([buf])[0]
    return _unbits(got, like.dtype)


# ---------------------------------------------------------------------------
# Autograd Functions
# ---------------------------------------------------------------------------


class CopyToGroup(torch.autograd.Function):
    """Identity forward, all-reduce backward: the input of a column-parallel
    projection, which every rank uses for its part of the output."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class ReduceFromGroup(torch.autograd.Function):
    """All-reduce forward, identity backward: the partial outputs of a
    row-parallel projection summed, or a loss summed over the ranks that
    each hold part of its tokens."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class GatherSeq(torch.autograd.Function):
    """All-gather along ``dim`` forward, reduce-scatter backward: a
    sequence-sharded activation made whole for attention or the MLP."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


class ScatterSeq(torch.autograd.Function):
    """Reduce-scatter along ``dim`` forward, all-gather backward: the partial
    outputs of a row-parallel projection summed and left sequence-sharded."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.group, ctx.dim), None, None


class HeadsToChunks(torch.autograd.Function):
    """``heads_to_chunks`` forward, ``chunks_to_heads`` of the cotangent
    backward: the ring's input under Megatron placement (JAX GSPMD's swap of
    the head-sharded q/k/v for the ring's ``P(batch, None, "model", None)``,
    ops/ring_attention.py:181-187 there)."""

    @staticmethod
    def forward(ctx, x, group, heads):
        ctx.group, ctx.heads = group, list(heads)
        return heads_to_chunks(x, group, ctx.heads)

    @staticmethod
    def backward(ctx, g):
        return chunks_to_heads(g, ctx.group, ctx.heads), None, None


class ChunksToHeads(torch.autograd.Function):
    """``chunks_to_heads`` forward, ``heads_to_chunks`` backward: the ring's
    output back to this rank's heads for the row-parallel ``c_proj``."""

    @staticmethod
    def forward(ctx, y, group, heads):
        ctx.group, ctx.heads = group, list(heads)
        return chunks_to_heads(y, group, ctx.heads)

    @staticmethod
    def backward(ctx, g):
        return heads_to_chunks(g, ctx.group, ctx.heads), None, None


class GatherRows(torch.autograd.Function):
    """The row-sharded ``w`` made whole (rank r holds ``sizes[r]`` rows).
    Backward: with ``partial`` every rank's gradient of the whole is a part
    of the sum (its own tokens) and is reduce-scattered; without, every rank
    computed the same gradient and keeps its own rows of it."""

    @staticmethod
    def forward(ctx, w, group, sizes, partial):
        ctx.group, ctx.sizes, ctx.partial = group, list(sizes), partial
        return all_gather(w, group, 0, sizes)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            return reduce_scatter(g, ctx.group, 0, ctx.sizes), None, None, None
        r = _rank(ctx.group)
        return g.narrow(0, sum(ctx.sizes[:r]), ctx.sizes[r]), None, None, None


# ---------------------------------------------------------------------------
# The train step's reductions
# ---------------------------------------------------------------------------


@torch.no_grad()
def _flat_all_reduce_(tensors, group, scale: Optional[float]) -> None:
    """Sum ``tensors`` over ``group`` through one flat fp32 buffer, times
    ``scale``, written back in place."""
    tensors = list(tensors)
    if not tensors:
        return
    counts["all_reduce"] += 1
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    if scale is not None:
        flat.mul_(scale)
    i = 0
    for t in tensors:
        t.copy_(flat[i:i + t.numel()].view_as(t))
        i += t.numel()


class GradSync:
    """What one optimizer step exchanges.

    mesh: parallel.mesh.Mesh. ``sharded``: names of the leaves split over
    ``model`` (each rank holds a part); ``partial``: names of the replicated
    leaves whose gradients are partial over ``model`` (each rank saw only
    its tokens: the replicated leaves under sequence parallelism).
    ``staged``: under the pipeline, the names of the leaves a stage holds
    alone (its layers); every other leaf is held by
    every stage and its gradient, formed where the stage uses it (the
    embeddings on the first, the head and ``ln_f`` on the last), is summed
    over ``pipe``. ``loss_is_global``: the loss of a micro-batch is already
    the mean over the whole ``data`` group (a masked mean whose count was
    summed over it), so gradients are summed over ``data``, and not
    averaged, and the loss is left as it is."""

    def __init__(self, mesh, *, sharded: Iterable[str] = (), partial: Iterable[str] = (),
                 staged: Optional[Iterable[str]] = None, loss_is_global: bool = False):
        self.mesh = mesh
        self.sharded, self.partial = set(sharded), set(partial)
        self.staged = None if staged is None else set(staged)
        self.loss_is_global = loss_is_global
        self.calls = 0  # grad all-reduces issued

    def _summed_over(self, name: str) -> tuple:
        axes = ("data",)
        if name in self.partial:
            axes += ("model",)
        if self.staged is not None and name not in self.staged:
            axes += ("pipe",)
        return tuple(a for a in axes if self.mesh.size(a) > 1)

    def _split_over(self, name: str) -> tuple:
        axes = ("model",) if name in self.sharded else ()
        if self.staged is not None and name in self.staged:
            axes += ("pipe",)
        return tuple(a for a in axes if self.mesh.size(a) > 1)

    def reduce_(self, grads: Dict[str, torch.Tensor]) -> None:
        """All-reduce the accumulated gradients in place, one flat buffer for
        each set of axes a gradient is summed over (``data`` always; also
        ``model`` for the partial leaves and ``pipe`` for the leaves every
        stage holds). Averaged over ``data`` unless the loss is global."""
        data = self.mesh.size("data")
        if self.mesh.world == 1:
            return
        scale = None if self.loss_is_global or data == 1 else 1.0 / data
        by_axes: Dict[tuple, list] = {}
        for n, g in grads.items():
            by_axes.setdefault(self._summed_over(n), []).append(g)
        for axes, gs in by_axes.items():
            if axes:
                _flat_all_reduce_(gs, self.mesh.group(axes), scale)
                self.calls += 1

    def mean_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The loss averaged over ``data`` (as it is when already global)."""
        data = self.mesh.size("data")
        if self.loss_is_global or data == 1:
            return loss
        return all_reduce_(loss.detach().float().clone(), self.mesh.group("data")) / data

    def norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The global norm of the reduced gradients: the squares of each leaf
        summed over the axes it is split on (``model`` for the sharded
        leaves, ``pipe`` for a stage's layers), every leaf counted once."""
        total = torch.zeros((), dtype=torch.float32, device=next(iter(grads.values())).device)
        by_axes: Dict[tuple, list] = {}
        for n, g in grads.items():
            by_axes.setdefault(self._split_over(n), []).append(g)
        for axes, gs in by_axes.items():
            sq = torch.stack([g.float().square().sum() for g in gs]).sum()
            if axes:
                sq = all_reduce_(sq.reshape(1), self.mesh.group(axes))[0]
            total = total + sq
        return total.sqrt()
