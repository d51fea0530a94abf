"""GPipe pipeline parallelism over the "pipe" axis of a process mesh.

Counterpart of gpt2_vision_language_tpu/parallel/pipeline.py. The JAX module
is one ``shard_map`` program whose stages hop activations with ``ppermute``;
here each stage is a process, a rank of the mesh's "pipe" group. Stage s
holds the decoder layers [s * L/S, (s + 1) * L/S) (``cut_stage``: the other
layers' places in ``model.transformer.h`` hold an ``Elsewhere``, which has
no parameters) and the embeddings and ``ln_f`` replicated, as JAX
``pipeline_param_pspecs`` (:50-77) places them; under pp x tp each stage's
layers are also cut Megatron-style over "model" (parallel/sharding.py).

The schedule (``Pipeline``; JAX ``make_pipeline_loss_fn`` :103 and
``pipeline_run_blocks`` :145): a grad-accumulation micro-batch of B rows is
split into ``n_micro`` equal sub-batches; stage 0 embeds each, every stage
runs its layers on each in turn and sends the output, in the compute dtype,
to stage s + 1; the last stage reassembles the (B, T, C) stream and takes
``ln_f`` and the fused CE of the whole micro-batch once, as JAX does after
its ``psum`` (:236-245). The backward runs the sub-batches in reverse: the
last stage differentiates the loss, then every stage calls
``torch.autograd.backward`` on a sub-batch's saved output with the cotangent
from stage s + 1 and sends the cotangent of its input to stage s - 1. The
loss is broadcast from the last stage, so every rank returns the same value.
The hops are blocking point-to-point sends (parallel/collectives.send and
recv, through pinned host memory where gloo carries CUDA tensors). A chain
has no cycle, so stage s runs sub-batch j + 1 while stage s + 1 runs
sub-batch j: GPipe's M + S - 1 ticks, a bubble of (S - 1) / (M + S - 1).

Not carried: JAX ``transport_dtype`` (:80), an XLA:CPU workaround that
widens the hops to fp32 on CPU meshes. The JAX stage casts to the compute
dtype on entry and back on exit, so an fp32 hop of a bf16 value carries the
value a bf16 hop carries: the port sends the compute dtype.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch
from torch import nn

from ..ckpt.convert import jax_leaf_path
from ..core.config import GPTConfig
from ..core.precision import DEFAULT_POLICY, Policy
from ..models import gpt2
from . import collectives as coll


class Stage:
    """Rank ``index`` of the ``count`` ranks of ``group`` (the mesh's "pipe"
    group): it holds ``layers``, the decoder layers [index * L/count,
    (index + 1) * L/count) of a model of ``n_layer`` layers."""

    def __init__(self, index: int, count: int, n_layer: int, group=None):
        if n_layer % count:
            raise ValueError(f"n_layer {n_layer} is not divisible by pp={count}")
        per = n_layer // count
        self.index, self.count, self.group = int(index), int(count), group
        self.layers = range(index * per, (index + 1) * per)
        self.first, self.last = index == 0, index == count - 1

    def __deepcopy__(self, memo):  # a process group is not copied
        return self

    def __repr__(self) -> str:
        return f"Stage({self.index} of {self.count}, layers {self.layers.start}-{self.layers.stop - 1})"


def stage_of(mesh, n_layer: int) -> Optional[Stage]:
    """This rank's Stage on ``mesh``; None without a "pipe" axis."""
    if mesh.size("pipe") == 1:
        return None
    return Stage(mesh.coord("pipe"), mesh.size("pipe"), n_layer, mesh.group("pipe"))


def layer_of(name: str) -> Optional[int]:
    """The decoder layer that the parameter ``name`` belongs to (the index on
    its JAX leaf's stacked layer axis); None for the embeddings, ``ln_f`` and
    the tied head."""
    return jax_leaf_path(name)[1]


def stage_param_specs(params: Dict[str, torch.Tensor], axis_name: str = "pipe") -> dict:
    """port name -> the JAX PartitionSpec entries of its layer-stacked leaf
    sharded on the layer axis (JAX ``stage_param_specs`` :43), for the
    parameters of the decoder blocks."""
    from ..train.optimizer import jax_leaves

    out = {}
    for leaf in jax_leaves(params).values():
        if leaf.layered:
            for n in leaf.names:
                out[n] = (axis_name,) + (None,) * (len(leaf.shape) - 1)
    return out


def pipeline_param_pspecs(params: Dict[str, torch.Tensor], axis_name: str = "pipe",
                          tp: bool = False) -> dict:
    """port name -> the JAX PartitionSpec entries of JAX
    ``pipeline_param_pspecs`` (:50): the block leaves stage-sharded on
    ``axis_name``, the rest replicated; with ``tp`` every leaf keeps its
    Megatron "model" entry under the leading stage axis."""
    stacked = stage_param_specs(params, axis_name)
    if not tp:
        return {n: stacked.get(n, ()) for n in params}
    from .sharding import gpt2_param_specs

    specs = gpt2_param_specs(params)
    return {n: (axis_name,) + tuple(sp)[1:] if n in stacked else sp for n, sp in specs.items()}


class Elsewhere(nn.Module):
    """The place of a decoder layer that another pipeline stage holds."""

    def __init__(self, index: int):
        super().__init__()
        self.index = index

    def extra_repr(self) -> str:
        return f"layer {self.index}"


def cut_stage(model, stage: Stage) -> None:
    """Keep ``stage``'s layers of ``model`` (a whole GPT2, the same on every
    rank) and drop the others, in place; hand ``stage`` to the model
    (``model.stage``)."""
    if model.cfg.cross_attention:
        raise NotImplementedError("the pipeline runs the plain decoder (pretraining)")
    h = model.transformer.h
    for i in range(len(h)):
        if i not in stage.layers:
            h[i] = Elsewhere(i)
    model.stage = stage


def local_stage(tree: dict, stage: Stage) -> dict:
    """A whole tree keyed by parameter name -> the entries ``stage`` holds."""
    return {n: t for n, t in tree.items() if layer_of(n) is None or layer_of(n) in stage.layers}


def gather_stages(tree: dict, stage: Stage) -> dict:
    """Every stage's tree keyed by parameter name -> the whole tree, on every
    stage (collective over the "pipe" group): a layer's tensors come from the
    stage that holds it, the other entries are every stage's own."""
    out, block = {}, {}
    for n, t in tree.items():
        i = layer_of(n)
        if i is None:
            out[n] = t
        else:
            block[(i - stage.layers.start, n.split(".", 3)[3])] = t
    per = len(stage.layers)
    for j, rest in sorted(block):
        pieces = coll.all_gather(block[(j, rest)].detach().contiguous().unsqueeze(0),
                                 stage.group, 0)
        for s in range(stage.count):
            out[f"transformer.h.{s * per + j}.{rest}"] = pieces[s]
    return out


@contextlib.contextmanager
def whole_stages(model, stats: Optional[dict] = None):
    """``model`` with every decoder layer in place while the block runs (the
    other stages' layers gathered over "pipe", as JAX's GSPMD gathers them
    for a whole-model program), for HellaSwag and sampling; the dropped
    layers are dropped again after. A model without a stage is itself.
    ``stats`` receives the gather's seconds and bytes."""
    stage = model.stage
    if stage is None:
        yield model
        return
    t0 = time.perf_counter()
    own = {n: p.detach() for n, p in model.named_parameters() if layer_of(n) is not None}
    whole = gather_stages(own, stage)
    h = model.transformer.h
    dev = next(iter(own.values())).device
    moved = 0
    for i in range(len(h)):
        if i in stage.layers:
            continue
        with torch.device(dev):
            b = gpt2.Block(model.cfg)
        for n, p in b.named_parameters():
            p.requires_grad_(False)
            p.data = whole[f"transformer.h.{i}.{n}"]
            moved += p.numel() * p.element_size()
        h[i] = b
    if stats is not None:
        stats.update(seconds=time.perf_counter() - t0, bytes=moved)
    try:
        yield model
    finally:
        for i in range(len(h)):
            if i not in stage.layers:
                h[i] = Elsewhere(i)


class Pipeline:
    """The GPipe schedule of a GPT-2 of ``cfg`` over ``stage``'s "pipe"
    group: ``loss(model, micro)`` (a forward, as validation runs it) and
    ``loss_grad(model, micro, acc)`` (the forward and the backward, the
    train step's ``layerwise_loss_grad`` seam: this stage's grads folded into
    ``acc``). ``micro``: {"x", "y"}, (B, T) token ids; B divisible by
    ``n_micro``. Both return the micro-batch's loss on every stage."""

    def __init__(self, cfg: GPTConfig, stage: Stage, *, n_micro: int,
                 policy: Policy = DEFAULT_POLICY, attn_impl: str = "auto", remat=False,
                 ce_chunks: int = 8):
        self.cfg, self.stage, self.n_micro = cfg, stage, int(n_micro)
        self.policy, self.attn_impl, self.remat, self.ce_chunks = policy, attn_impl, remat, ce_chunks

    # -- the hops (a control of chip_smoke.py replaces the backward ones) ----

    def send_activation(self, h):
        coll.send(h, self.stage.group, self.stage.index + 1)

    def recv_activation(self, like):
        return coll.recv(like, self.stage.group, self.stage.index - 1)

    def send_cotangent(self, g):
        coll.send(g, self.stage.group, self.stage.index - 1)

    def recv_cotangent(self, like):
        return coll.recv(like, self.stage.group, self.stage.index + 1)

    # -- the schedule --------------------------------------------------------

    def _split(self, t):
        if t.shape[0] % self.n_micro:
            raise ValueError(f"a micro-batch of {t.shape[0]} rows is not divisible into "
                             f"n_micro={self.n_micro} sub-batches")
        return t.chunk(self.n_micro)

    def _forward(self, model, subs, dtype, embed: bool):
        """Each sub-batch through this stage's layers, in order: (inputs,
        outputs). Stage 0 takes ``subs`` (ids to embed, or the embedded
        stream), the others receive from the stage before."""
        st, c = self.stage, self.cfg
        ins, outs = [], []
        for sub in subs:
            if st.first:
                h = gpt2.embed_tokens(model, sub, c).to(dtype) if embed else sub
            else:
                h = self.recv_activation(torch.empty((*sub.shape[:2], c.n_embd), dtype=dtype,
                                                     device=sub.device))
                if torch.is_grad_enabled():
                    h.requires_grad_(True)
            out = gpt2.run_blocks(model, h, c, policy=self.policy, attn_impl=self.attn_impl,
                                  remat=self.remat, layers=st.layers)
            if not st.last:
                self.send_activation(out)
            ins.append(h)
            outs.append(out)
        return ins, outs

    def _from_last(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` of the last stage, on every stage."""
        if self.stage.group is not None:
            coll.broadcast_(t, self.stage.group, self.stage.count - 1)
        return t

    def _loss_everywhere(self, loss, device) -> torch.Tensor:
        t = (loss.detach().float().reshape(1) if loss is not None
             else torch.zeros(1, dtype=torch.float32, device=device))
        return self._from_last(t)[0]

    def loss(self, model, micro) -> torch.Tensor:
        """The micro-batch's mean CE through the pipeline, without a backward."""
        x = micro["x"]
        _, outs = self._forward(model, self._split(x), self.policy.compute_dtype, embed=True)
        loss = None
        if self.stage.last:
            loss = gpt2.head_loss(model, torch.cat(outs), micro["y"], policy=self.policy,
                                  ce_chunks=self.ce_chunks)
        return self._loss_everywhere(loss, x.device)

    def loss_grad(self, model, micro, acc) -> torch.Tensor:
        """The forward and backward of the micro-batch through the pipeline;
        this stage's parameter grads are folded into ``acc`` (``acc.add``)."""
        st, x = self.stage, micro["x"]
        loss, cots = None, None
        with torch.enable_grad():
            ins, outs = self._forward(model, self._split(x), self.policy.compute_dtype,
                                      embed=True)
            if st.last:
                hs = [o.detach().requires_grad_(True) for o in outs]
                loss = gpt2.head_loss(model, torch.cat(hs), micro["y"], policy=self.policy,
                                      ce_chunks=self.ce_chunks)
                loss.backward()
                cots = [h.grad for h in hs]
            for j in reversed(range(len(outs))):
                g = cots[j] if st.last else self.recv_cotangent(outs[j])
                torch.autograd.backward(outs[j], g)
                if not st.first:
                    self.send_cotangent(ins[j].grad)
                ins[j] = outs[j] = None
        for n, p in gpt2.named_params(model).items():
            if p.grad is not None:
                acc.add(n, p.grad)
                p.grad = None
        return self._loss_everywhere(loss, x.device)

    @torch.no_grad()
    def run_blocks(self, model, x):
        """The blocks over the embedded stream x (B, T, C) (stage 0's), the
        output on every stage."""
        _, outs = self._forward(model, self._split(x), x.dtype, embed=False)
        out = torch.cat(outs) if self.stage.last else torch.empty_like(x)
        return self._from_last(out)


def make_pipeline_loss_fn(cfg: GPTConfig, mesh, *, n_micro: int = 2,
                          policy: Policy = DEFAULT_POLICY, attn_impl: str = "auto",
                          ce_chunks: int = 8, remat=False) -> Pipeline:
    """The pipelined loss of JAX ``make_pipeline_loss_fn`` (:103) over the
    mesh's "pipe" axis: a ``Pipeline``, whose ``loss`` the eval step takes
    and whose ``loss_grad`` the train step takes as ``layerwise_loss_grad``
    (train/step.py make_train_step)."""
    stage = stage_of(mesh, cfg.n_layer) or Stage(0, 1, cfg.n_layer)
    return Pipeline(cfg, stage, n_micro=n_micro, policy=policy, attn_impl=attn_impl,
                    remat=remat, ce_chunks=ce_chunks)


def pipeline_run_blocks(model, x, cfg: GPTConfig, *, n_micro: int = 2,
                        policy: Policy = DEFAULT_POLICY, attn_impl: str = "auto"):
    """JAX ``pipeline_run_blocks`` (:145): the decoder blocks over the
    embedded x (B, T, C) through the GPipe schedule of the model's stage
    (``model.stage``), in ``n_micro`` sub-batches; the same value as
    ``models.gpt2.run_blocks`` up to fp32 reduction order, on every stage."""
    if model.stage is None:
        return gpt2.run_blocks(model, x, cfg, policy=policy, attn_impl=attn_impl)
    return Pipeline(cfg, model.stage, n_micro=n_micro, policy=policy,
                    attn_impl=attn_impl).run_blocks(model, x)
