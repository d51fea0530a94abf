"""Megatron tensor parallelism (with sequence parallelism) of the port's
GPT-2 over the ``model`` axis of a process mesh.

Counterpart of gpt2_vision_language_tpu/parallel/sharding.py. The JAX package
annotates parameter shardings and lets GSPMD place the collectives; here each
rank holds its shards as the parameters of an ordinary ``models.gpt2.GPT2``
(``shard_model``), and the forward (models/gpt2.py) reads the
``TensorParallel`` the model carries as ``model.tp`` to insert the
collectives of parallel/collectives.py. The split, by the JAX leaf name
(``ckpt/convert.jax_leaf_name``), as JAX ``_spec_for`` (:25 there):

  * ``wqkv``/``bqkv``, ``wfc``/``bfc`` and the cross-attention's ``wq``/``bq``,
    ``wkv``/``bkv``: column-parallel (each rank computes its heads, its slice
    of the MLP's hidden);
  * ``wo`` and ``wproj``: row-parallel, followed by one all-reduce per
    residual branch (with sequence parallelism a reduce-scatter on T);
  * ``wte``: vocab rows split; the embedding is a masked lookup summed over
    ``model`` and the tied head gathers the rows back (``GatherRows``);
  * everything else replicated.

Heads split in whole heads, unevenly where they must (``split_counts``: 6
heads over 4 ranks are 2, 2, 1, 1; 1558M's 25 are 7, 6, 6, 6); a QKV rank
holds the rows of its heads in each of the q, k and v sections. GSPMD cuts
the JAX leaves in equal slices instead; the function computed is the same.

With ``seq_parallel`` (JAX ``seq_parallel_sharding`` :61) the residual
stream between blocks is T-sharded over ``model``: each LayerNorm and each
replicated leaf sees T/tp tokens, the row-parallel projections reduce-scatter
and the column-parallel ones all-gather their input; the grads of the
replicated leaves are then partial and summed over ``model`` by the train
step (``parallel/collectives.GradSync``).

With ``attn_impl="ring"`` the placement is the same (JAX ``shard_params``
splits over "model" whatever the attention): the ring runs inside attention
only. ``TensorParallel.ring_attention`` swaps this rank's heads over the
whole sequence for every head over its T/tp chunk (``HeadsToChunks``, one
all-to-all of q, k and v together), runs the ring over the ``model`` group
(ops/ring_attention.GroupRing) and swaps back (``ChunksToHeads``) for the
row-parallel ``c_proj``: JAX ops/ring_attention.py:181-187, where GSPMD
places the same two swaps around the ring's shard_map. Everything else is
the Megatron block above, sequence parallelism and the layerwise backward
included.

``shard_params`` / ``gather_params`` move whole tensors to each rank's shards
and back (state dicts and AdamW moments); checkpoints hold gathered trees.
``Placement`` is what a rank holds under TP and the pipeline together, and
where its 8-bit moments lie on the whole leaves' block grid (JAX
``moment_specs`` :76-129); ``setup_parallel`` wires a train step's parallel
styles.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..ckpt.convert import jax_leaf_name
from ..core.config import GPTConfig
from . import collectives as coll

COLUMN = ("wqkv", "bqkv", "wfc", "bfc", "wq", "bq", "wkv", "bkv")
ROW = ("wo", "wproj")
VOCAB = ("wte",)
# the q/k/v (k/v) sections of a packed column-parallel leaf, split by heads
_SECTIONS = {"wqkv": 3, "bqkv": 3, "wq": 1, "bq": 1, "wkv": 2, "bkv": 2}


def split_counts(n: int, parts: int) -> List[int]:
    """n items over ``parts`` ranks, the first ranks one more where n does
    not divide (6 over 4 -> 2, 2, 1, 1)."""
    q, r = divmod(int(n), int(parts))
    return [q + (1 if i < r else 0) for i in range(parts)]


def _spec_for(leaf: str, ndim: int) -> tuple:
    """The JAX PartitionSpec entries of the JAX leaf named ``leaf`` (its
    stacked layout), as JAX ``_spec_for`` gives them."""
    if leaf == "wte":
        return ("model", None)
    if leaf in ("wqkv", "wfc", "wq", "wkv"):
        return (None, None, "model")
    if leaf in ("bqkv", "bfc", "bq", "bkv"):
        return (None, "model")
    if leaf in ("wo", "wproj"):
        return (None, "model", None)
    return (None,) * ndim


def gpt2_param_specs(params: Dict[str, torch.Tensor]) -> Dict[str, tuple]:
    """port name -> the JAX PartitionSpec entries of the JAX leaf it belongs
    to (JAX ``gpt2_param_specs`` :47, keyed by the port's names)."""
    from ..train.optimizer import jax_leaves

    out = {}
    for leaf in jax_leaves(params).values():
        spec = _spec_for(leaf.path.rsplit("/", 1)[-1], len(leaf.shape))
        for n in leaf.names:
            out[n] = spec
    return out


def sharded_names(names) -> set:
    """The names of the parameters split over ``model``."""
    return {n for n in names if _kind(n) is not None}


def _kind(name: str) -> Optional[str]:
    try:
        leaf = jax_leaf_name(name)
    except KeyError:
        return None
    if leaf in COLUMN:
        return "column"
    if leaf in ROW:
        return "row"
    if leaf in VOCAB:
        return "vocab"
    return None


class TensorParallel:
    """Rank ``rank`` of the ``size`` ranks of ``group`` (the mesh's ``model``
    axis) for a GPT-2 of ``cfg``: its heads, MLP columns and vocab rows, and
    the collectives of its forward. ``seq_parallel`` T-shards the residual
    stream where a caller allows it (``view(seq_parallel=True)``)."""

    _ring = None  # the GroupRing of ``ring_attention``, made at its first call

    def __init__(self, group, rank: int, size: int, cfg: GPTConfig, *,
                 seq_parallel: bool = False):
        self.group, self.rank, self.size = group, int(rank), int(size)
        self.seq_parallel = bool(seq_parallel)
        self.sp = False  # whether this view T-shards the residual stream
        self.head_dim = cfg.head_dim
        self.heads = split_counts(cfg.n_head, size)
        self.hidden = split_counts(4 * cfg.n_embd, size)
        self.vocab = split_counts(cfg.padded_vocab_size, size)

    def __deepcopy__(self, memo):  # a process group is not copied
        return self

    def view(self, seq_parallel: bool) -> "TensorParallel":
        """This context with the residual stream T-sharded when
        ``seq_parallel`` and the run asked for it, whole otherwise."""
        want = seq_parallel and self.seq_parallel
        if want == self.sp:
            return self
        out = object.__new__(TensorParallel)
        out.__dict__.update(self.__dict__)
        out.sp = want
        return out

    # -- what this rank holds ------------------------------------------------

    def _start(self, counts) -> int:
        return sum(counts[:self.rank])

    def index(self, name: str, shape) -> Optional[tuple]:
        """(dim, LongTensor of indices) of this rank's part of the parameter
        ``name`` of the whole ``shape`` (torch layout), or None when it is
        replicated."""
        return self.index_of(self.rank, name, shape)

    def index_of(self, rank: int, name: str, shape) -> Optional[tuple]:
        kind = _kind(name)
        if kind is None:
            return None
        leaf = jax_leaf_name(name)
        hs = self.head_dim
        if kind == "vocab":
            c = self.vocab
            s = sum(c[:rank])
            return 0, torch.arange(s, s + c[rank])
        if leaf in _SECTIONS:  # heads, in each packed section
            c = self.heads
            h0 = sum(c[:rank]) * hs
            width = shape[0] // _SECTIONS[leaf]
            idx = torch.cat([sec * width + torch.arange(h0, h0 + c[rank] * hs)
                             for sec in range(_SECTIONS[leaf])])
            return 0, idx
        if leaf in ("wfc", "bfc"):
            c = self.hidden
            s = sum(c[:rank])
            return 0, torch.arange(s, s + c[rank])
        # row-parallel: the input features of the heads (wo) or of the hidden
        c = self.heads if leaf == "wo" else self.hidden
        unit = hs if leaf == "wo" else 1
        s = sum(c[:rank]) * unit
        return 1, torch.arange(s, s + c[rank] * unit)

    # -- forward collectives -------------------------------------------------

    def enter(self, x):
        """The input of a column-parallel projection: whole on every rank
        (all-gathered on T under sequence parallelism)."""
        if self.sp:
            return coll.GatherSeq.apply(x, self.group, 1)
        return coll.CopyToGroup.apply(x, self.group)

    def leave(self, y):
        """The partial outputs of a row-parallel projection summed (and
        reduce-scattered on T under sequence parallelism)."""
        if self.sp:
            return coll.ScatterSeq.apply(y, self.group, 1)
        return coll.ReduceFromGroup.apply(y, self.group)

    def embed(self, wte_local, idx):
        """The vocab-parallel embedding lookup: each rank looks up the ids of
        its rows, zero elsewhere, and the ranks' rows are summed (left
        T-sharded under sequence parallelism)."""
        v0 = self._start(self.vocab)
        local = idx - v0
        inside = (local >= 0) & (local < wte_local.shape[0])
        e = torch.nn.functional.embedding(local.clamp(0, wte_local.shape[0] - 1), wte_local)
        e = torch.where(inside[..., None], e, torch.zeros((), dtype=e.dtype, device=e.device))
        return self.leave(e)

    def full_wte(self, wte_local):
        """The whole tied head weight: the vocab rows gathered. Its gradient is
        reduce-scattered when each rank's tokens are its own (sequence
        parallelism), kept row by row when every rank computed the same."""
        return coll.GatherRows.apply(wte_local, self.group, self.vocab, self.sp)

    def seq_slice(self, t):
        """This rank's part of a (B, T, ...) tensor on T."""
        n = t.shape[1] // self.size
        return t[:, self.rank * n:(self.rank + 1) * n]

    def ring_attention(self, qkv):
        """Causal attention of this rank's heads over the whole sequence by
        the ring over ``model``: ``qkv`` (B, T, 3, heads[rank], hs), this
        rank's q, k and v sections of the fused projection -> (B, T,
        heads[rank], hs). T divides by the ring's size."""
        from ..ops.ring_attention import GroupRing, ring_attention

        if self._ring is None:
            self._ring = GroupRing(self.group)
        chunk = coll.HeadsToChunks.apply(qkv, self.group, self.heads)
        q, k, v = chunk.unbind(2)
        y = ring_attention(q, k, v, self._ring)
        return coll.ChunksToHeads.apply(y, self.group, self.heads)


def shard_params(tree: Dict[str, torch.Tensor], tp: TensorParallel) -> Dict[str, torch.Tensor]:
    """Whole tensors keyed by parameter name (a state dict, or one AdamW
    moment) -> this rank's shards; other entries pass through."""
    out = {}
    for n, t in tree.items():
        where = tp.index(n, t.shape) if isinstance(t, torch.Tensor) and t.dim() else None
        out[n] = t if where is None else t.index_select(where[0], where[1].to(t.device)).contiguous()
    return out


def _whole_of(t: torch.Tensor, tp: TensorParallel, name: str, shape, lead: int = 0):
    """Every rank's shard ``t`` of the parameter ``name`` (whole ``shape``)
    -> the whole tensor (collective). ``lead``: leading axes of ``t`` before
    the parameter's (stacked tensors)."""
    dim = tp.index(name, shape)[0] + lead
    sizes = [len(tp.index_of(r, name, shape)[1]) for r in range(tp.size)]
    pieces = coll.all_gather(t.contiguous(), tp.group, dim, sizes)
    whole = t.new_empty(tuple(t.shape[:lead]) + tuple(shape))
    at = 0
    for r in range(tp.size):
        idx = tp.index_of(r, name, shape)[1].to(t.device)
        whole.index_copy_(dim, idx, pieces.narrow(dim, at, sizes[r]))
        at += sizes[r]
    return whole


def gather_params(tree: Dict[str, torch.Tensor], tp: TensorParallel,
                 shapes: Dict[str, tuple]) -> Dict[str, torch.Tensor]:
    """Every rank's shards -> whole tensors, on every rank (collective).
    ``shapes``: the whole shape of each sharded name."""
    out = {}
    for n, t in tree.items():
        if n not in shapes or tp.index(n, shapes[n]) is None:
            out[n] = t
        else:
            out[n] = _whole_of(t, tp, n, shapes[n])
    return out


def shard_model(model, tp: TensorParallel):
    """Replace each split parameter of ``model`` (a whole GPT2, the same on
    every rank) by this rank's shard, in place, and hand ``tp`` to the model
    (``model.tp``, which models/gpt2.py reads). Returns {name: whole shape}
    of the split parameters, the state dict's tied ``lm_head.weight`` too."""
    if model.cfg.cross_attention:
        raise NotImplementedError(
            "tensor parallelism of the cross-attention decoder is not ported "
            "(ROADMAP, Not carried); the fine-tunes run data-parallel")
    shapes = {}
    with torch.no_grad():
        for n, p in model.named_parameters():
            where = tp.index(n, p.shape)
            if where is None:
                continue
            shapes[n] = tuple(p.shape)
            p.data = p.data.index_select(where[0], where[1].to(p.device)).contiguous()
    shapes["lm_head.weight"] = shapes["transformer.wte.weight"]  # tied: the state dict's key
    model.tp = tp
    return shapes


class Placement:
    """What this rank holds of the whole model and of its AdamW moments (JAX
    ``pipeline_param_pspecs`` and ``moment_specs`` over processes).

    ``tp``: its Megatron shards (None without TP), ``shapes`` their whole
    shapes; ``stage``: its pipeline stage (None without the pipeline);
    ``leaves``: the JAX leaves of the whole model (train/optimizer.
    jax_leaves). ``whole`` and ``local`` move a tree keyed by parameter name
    (a state dict, a moment tree) between this rank's part and the whole
    (``whole`` is collective): checkpoints hold whole trees.

    8-bit moments (JAX ``moment_specs``, parallel/sharding.py:76-129 there):
    the {q, s} buffers of a JAX leaf are the whole leaf's, on the one-process
    grid of 256-element blocks over the JAX leaf's element order, wherever
    its parameter is held. They are split in contiguous slices over the
    model axes present ("pipe", then "model": slice k = pipe coord * tp +
    model coord) when npad % (256 * ways) == 0, and held whole by every rank
    otherwise (``q8_slice``). ``update_q8`` updates the rank's slice: it
    gathers over "model" the parameter and gradient of a leaf split there
    (a column or vocab shard is no flat range), updates the slice's elements
    and codes, and gathers the updated slices back over "model" (and over
    "pipe" for a leaf every stage holds), each rank keeping its own part. A
    stage's slice of a block leaf is its own layers: under the pipeline
    alone those update with no collective."""

    def __init__(self, mesh, leaves: dict, *, tp: Optional[TensorParallel] = None,
                 shapes: Optional[Dict[str, tuple]] = None, stage=None):
        self.mesh, self.leaves, self.tp, self.stage = mesh, leaves, tp, stage
        self.shapes = dict(shapes or {})
        self.axes = (("pipe",) if stage is not None else ()) + (("model",) if tp is not None else ())
        self.ways = 1
        for a in self.axes:
            self.ways *= mesh.size(a)
        self.k = ((mesh.coord("pipe") * mesh.size("model") if stage is not None else 0)
                  + (mesh.coord("model") if tp is not None else 0))

    @property
    def split(self) -> bool:
        """Whether this rank holds less than the whole model."""
        return self.tp is not None or self.stage is not None

    def whole_names(self) -> List[str]:
        return [n for leaf in self.leaves.values() for n in leaf.names]

    # -- trees ----------------------------------------------------------------

    def whole(self, tree: dict) -> dict:
        """This rank's tree -> the whole tree, on every rank (collective)."""
        from .pipeline import gather_stages

        out = dict(tree)
        for path in sorted(k for k, v in tree.items() if isinstance(v, dict)):
            out[path] = self._whole_q8(path, tree[path])
        if self.tp is not None:
            out = gather_params(out, self.tp, self.shapes)
        if self.stage is not None:
            out = gather_stages(out, self.stage)
        return out

    def local(self, tree: dict) -> dict:
        """A whole tree -> this rank's part of it."""
        from ..train.optimizer import Q8_BLOCK
        from .pipeline import local_stage

        out = {}
        for n, t in tree.items():
            lo, hi, aligned = self.q8_slice(self.leaves[n]) if isinstance(t, dict) else (0, 0, False)
            out[n] = ({"q": t["q"][lo:hi].clone(), "s": t["s"][lo // Q8_BLOCK:hi // Q8_BLOCK].clone()}
                      if aligned else t)
        if self.tp is not None:
            out = shard_params(out, self.tp)
        if self.stage is not None:
            out = local_stage(out, self.stage)
        return out

    # -- 8-bit moments --------------------------------------------------------

    def q8_slice(self, leaf):
        """(lo, hi, aligned): the padded flat range of ``leaf``'s 8-bit
        buffers this rank holds; the whole [0, npad) unless aligned."""
        from ..train.optimizer import Q8_BLOCK, _q8_padded

        npad = _q8_padded(leaf.size)
        if self.ways == 1 or npad % (Q8_BLOCK * self.ways):
            return 0, npad, False
        w = npad // self.ways
        return self.k * w, (self.k + 1) * w, True

    def q8_sizes(self) -> Dict[str, int]:
        """JAX path -> the padded length of this rank's 8-bit buffers, for the
        leaves whose moments are 8-bit (decided on the whole leaf)."""
        from ..train.optimizer import _q8_eligible

        out = {}
        for path, leaf in self.leaves.items():
            if _q8_eligible(leaf.shape):
                lo, hi, _ = self.q8_slice(leaf)
                out[path] = hi - lo
        return out

    def _whole_q8(self, path: str, mq: dict) -> dict:
        if not self.q8_slice(self.leaves[path])[2]:
            return mq
        q, s = mq["q"], mq["s"]
        for axis in ("model", "pipe"):
            if axis in self.axes:
                q = coll.all_gather(q.contiguous(), self.mesh.group(axis))
                s = coll.all_gather(s.contiguous(), self.mesh.group(axis))
        return {"q": q, "s": s}

    def update_q8(self, path, params, grads, mq, vq, lr, clip_scale, bc1, bc2, cfg, wd) -> None:
        """The 8-bit AdamW update of the JAX leaf ``path``: this rank's slice of
        its codes and scales, and this rank's part of its parameter, in place
        (collective over the leaf's axes; train/optimizer.adamw_update)."""
        from ..train.optimizer import q8_update_flat

        leaf = self.leaves[path]
        rows = leaf.shape[0]
        r0, r1 = ((self.stage.layers.start, self.stage.layers.stop)
                  if leaf.layered and self.stage is not None else (0, rows))
        per = leaf.size // rows
        names = leaf.names[r0:r1] if leaf.layered else leaf.names
        p_w, g_w, split = {}, {}, {}
        for n in names:
            where = None if self.tp is None else self.tp.index(n, self.shapes.get(n, params[n].shape))
            if where is None:
                p_w[n], g_w[n] = params[n], grads[n]
            else:
                both = _whole_of(torch.stack([params[n].float(), grads[n].float()]), self.tp, n,
                                 self.shapes[n], lead=1)
                p_w[n], g_w[n] = both[0], both[1]
                split[n] = where
        p, g = leaf.gather(p_w, r0, r1), leaf.gather(g_w, r0, r1)
        a0, a1 = r0 * per, r1 * per
        lo, hi, aligned = self.q8_slice(leaf)
        hi = min(hi, leaf.size)
        at = a0
        if lo < a0 or hi > a1:  # a block leaf held whole in 8 bits: every stage's layers
            p, g = (coll.all_gather(t, self.stage.group) for t in (p, g))
            at = 0
        new = q8_update_flat(p[lo - at:hi - at], g[lo - at:hi - at], mq, vq, lr, clip_scale,
                             bc1, bc2, cfg, wd)
        if aligned:
            for axis in ("model", "pipe"):
                if axis in self.axes and not (axis == "pipe" and leaf.layered):
                    new = coll.all_gather(new, self.mesh.group(axis))
        else:
            new = new[a0:a1]
        leaf.scatter(p_w, r0, r1, new)
        for n, (dim, idx) in split.items():
            params[n].copy_(p_w[n].index_select(dim, idx.to(p_w[n].device)))


def setup_parallel(model, mesh, *, seq_parallel: bool = False, make_sync=None):
    """The parallel wiring of a train step over ``mesh`` (a parallel.mesh.Mesh
    on ("data", "model"), ("data", "pipe") or ("data", "pipe", "model")),
    the one the trainer and the worker share.

    With ``model`` > 1, Megatron TP, whatever the attention (the ring over
    processes runs inside it, ``TensorParallel.ring_attention``): ``model``
    (whole, the same on every rank) is cut to this rank's shards in place
    (``shard_model``); with ``pipe`` > 1 to its stage's layers
    (parallel/pipeline.cut_stage). On more than one process, the step's
    ``GradSync`` (or ``make_sync``'s, built with the same arguments): the
    sharded leaves' squares are summed over ``model`` and a stage's layers'
    over ``pipe`` in the clip norm, the grads of the replicated leaves are
    summed over ``model`` under sequence parallelism (each rank saw only its
    tokens), and those of the leaves every stage holds over ``pipe``.
    Returns (the rank's ``Placement``, the GradSync or None on one
    process)."""
    from ..train.optimizer import jax_leaves
    from .pipeline import cut_stage, layer_of, stage_of

    leaves = jax_leaves(dict(model.named_parameters()))
    n_model = mesh.size("model")
    tp, shapes = None, {}
    if n_model > 1:
        tp = TensorParallel(mesh.group("model"), mesh.coord("model"), n_model, model.cfg,
                            seq_parallel=seq_parallel)
        shapes = shard_model(model, tp)
    stage = stage_of(mesh, model.cfg.n_layer)
    if stage is not None:
        cut_stage(model, stage)
    placement = Placement(mesh, leaves, tp=tp, shapes=shapes, stage=stage)
    if mesh.world == 1:
        return placement, None
    names = {n for n, _ in model.named_parameters()}
    sharded = sharded_names(names) if tp is not None else set()
    partial = names - sharded if seq_parallel else set()
    staged = None if stage is None else {n for n in names if layer_of(n) is not None}
    return placement, (make_sync or coll.GradSync)(mesh, sharded=sharded, partial=partial,
                                                   staged=staged)
