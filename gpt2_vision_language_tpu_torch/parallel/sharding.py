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

``shard_params`` / ``gather_params`` move whole tensors to each rank's shards
and back (state dicts and AdamW moments); checkpoints hold gathered trees.
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


def shard_params(tree: Dict[str, torch.Tensor], tp: TensorParallel) -> Dict[str, torch.Tensor]:
    """Whole tensors keyed by parameter name (a state dict, or one AdamW
    moment) -> this rank's shards; other entries pass through."""
    out = {}
    for n, t in tree.items():
        where = tp.index(n, t.shape) if isinstance(t, torch.Tensor) and t.dim() else None
        out[n] = t if where is None else t.index_select(where[0], where[1].to(t.device)).contiguous()
    return out


def gather_params(tree: Dict[str, torch.Tensor], tp: TensorParallel,
                 shapes: Dict[str, tuple]) -> Dict[str, torch.Tensor]:
    """Every rank's shards -> whole tensors, on every rank (collective).
    ``shapes``: the whole shape of each sharded name."""
    out = {}
    for n, t in tree.items():
        if n not in shapes or tp.index(n, shapes[n]) is None:
            out[n] = t
            continue
        dim = tp.index(n, shapes[n])[0]
        sizes = [len(tp.index_of(r, n, shapes[n])[1]) for r in range(tp.size)]
        pieces = coll.all_gather(t.contiguous(), tp.group, dim, sizes)
        whole = t.new_empty(shapes[n])
        at = 0
        for r in range(tp.size):
            idx = tp.index_of(r, n, shapes[n])[1].to(t.device)
            whole.index_copy_(dim, idx, pieces.narrow(dim, at, sizes[r]))
            at += sizes[r]
        out[n] = whole
    return out


def shard_model(model, tp: TensorParallel):
    """Replace each split parameter of ``model`` (a whole GPT2, the same on
    every rank) by this rank's shard, in place, and hand ``tp`` to the model
    (``model.tp``, which models/gpt2.py reads). Returns {name: whole shape}
    of the split parameters, the state dict's tied ``lm_head.weight`` too."""
    if model.cfg.cross_attention:
        raise NotImplementedError(
            "tensor parallelism of the cross-attention decoder is not ported "
            "(ROADMAP Queue 1 item 10); the fine-tunes run data-parallel")
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


def setup_parallel(model, mesh, *, seq_parallel: bool = False, ring: bool = False,
                   make_sync=None):
    """The parallel wiring of a train step over ``mesh`` (a ("data", "model")
    parallel.mesh.Mesh), the one the trainer and the worker share.

    With ``model`` > 1 and no ring, Megatron TP: ``model`` (whole, the same on
    every rank) is cut to this rank's shards in place (``shard_model``). On
    more than one process, the step's ``GradSync`` (or ``make_sync``'s, built
    with the same arguments): the sharded leaves' squares are summed over
    ``model`` in the clip norm, and the grads partial over ``model`` (each
    rank saw only its tokens: the replicated leaves under sequence
    parallelism, every leaf in the process ring) are summed over it. Returns
    (the TensorParallel or None, {name: whole shape}, the GradSync or None
    on one process)."""
    n_model = mesh.size("model")
    tp, shapes = None, {}
    if n_model > 1 and not ring:
        tp = TensorParallel(mesh.group("model"), mesh.coord("model"), n_model, model.cfg,
                            seq_parallel=seq_parallel)
        shapes = shard_model(model, tp)
    if mesh.world == 1:
        return tp, shapes, None
    names = {n for n, _ in model.named_parameters()}
    sharded = sharded_names(names) if tp is not None else set()
    if ring and n_model > 1:
        partial = names
    else:
        partial = names - sharded if seq_parallel else set()
    return tp, shapes, (make_sync or coll.GradSync)(mesh, sharded=sharded, partial=partial)


def ring_chunk_loss(mesh, cfg: GPTConfig, policy, *, remat=False):
    """``loss(model, x, y)`` of the ring over the mesh's ``model`` group: this
    rank's chunk of every (B, T) sequence, T/tp tokens from r * T/tp, its
    positions offset so, the mean taken over the group's tokens."""
    from ..models import gpt2

    r, n, group = mesh.coord("model"), mesh.size("model"), mesh.group("model")

    def loss(model, x, y):
        tl = x.shape[1] // n
        cut = slice(r * tl, (r + 1) * tl)
        return gpt2.loss(model, x[:, cut], cfg, targets=y[:, cut], policy=policy,
                         attn_impl="ring", remat=remat, pos_offset=r * tl, group=group)

    return loss
