"""One rank of a multi-process run of the port, driven by a JSON job.

    python -m gpt2_vision_language_tpu_torch.tools.dist_worker JOB.json

under ``python -m torch.distributed.run --nproc_per_node N`` (or ``launch``
below, which sets the same variables: MASTER_ADDR, MASTER_PORT, RANK,
WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE). The job's ``kind``:

  * ``"step"``: train steps of a GPT-2 on a ("data", "model") mesh of shape
    ``mesh``, or with ``pp`` > 1 a ("data", "pipe", "model") mesh of shape
    (mesh[0], pp, mesh[1]): data parallelism, Megatron tensor parallelism
    (``mesh[1] > 1``, ``seq_parallel``), the ring over the model group inside
    its attention (``ring``), the GPipe pipeline (``pp``, ``pp_micro``
    sub-batches a micro-batch), the layerwise backward (``layerwise``);
    ``opt_state_dtype`` the moments' storage. The whole
    weights come from ``init`` (a state dict file) or from ``seed``; the
    rows from ``rows`` (an ``.npy`` of (steps, accum, B, T + 1) token ids,
    the global batch: data rank d takes rows [d * B / data, (d + 1) * B /
    data)). ``fault`` runs a deliberately wrong step (``FaultySync``,
    ``faulty_pipeline``, ``faulty_placement``, ``faulty_ring``). With
    ``mesh`` [1, 1] and no ``pp`` it is the one-process step (``run_job`` in the caller's own
    process), the ring then a LocalRing of ``ring_size`` chunks.
  * ``"ftstep"``: one optimizer step of a caption fine-tune, data-parallel
    (``fault`` as for ``"step"``).
  * ``"pretrain"``: ``train.pretrain.run_pretrain`` of the job's config.
  * ``"finetune"``: ``train.finetune.run_finetune`` of the job's config.
  * ``"cli"``: ``cli.pretrain.main(argv)``, the command line of the job's
    ``argv`` (its ``--device`` names the card), the architecture replaced by
    ``model`` where the job gives one.

``device`` is every job's card (default ``"cuda"``: local rank i on
``cuda:i``; ``"cuda:0"`` puts every rank on that card; the CPU only by
``"cpu"``) and ``policy`` its precision policy (default ``"bf16"``, the
trainers' own). Each rank writes ``{out}/{tag}_r{rank}.json``: the step
metrics, this rank's kernel launch counts over the job (``launch_counts``)
and its exchanges staged through host memory (``host_staged``), its peak
device memory and seconds; a ``"step"`` job also its collectives a step
(``collectives``), its parameters' shapes and bytes and its moments' bytes
(``param_shapes``, ``param_bytes``, ``moment_bytes``; ``whole_param_bytes``
those of the whole model). Rank 0 of a
``"step"`` job also writes ``{tag}_whole.pt``: the whole (gathered) params
before and after and the whole reduced grads of the last step.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from ..core.config import (BridgeConfig, FinetuneConfig, GPTConfig, OptimizerConfig,
                           PretrainConfig, ScheduleConfig)
from ..core.precision import DEFAULT_POLICY, FP32_POLICY
from ..parallel.collectives import GradSync

POLICIES = {"fp32": FP32_POLICY, "bf16": DEFAULT_POLICY}


def _policy(job):
    return POLICIES[job.get("policy", "bf16")]


def _device(job) -> str:
    return job.get("device", "cuda")


def kernel_counters():
    """name -> the wrapper whose ``launches`` counts that kernel's launches."""
    from ..ops import flash_attention as fa
    from ..ops import fused_adamw as fw
    from ..ops import fused_ce as fc

    return {"flash_fwd": fa.flash_attention, "flash_fwd_f32": fa.flash_forward_f32,
            "flash_bwd": fa.flash_attention_backward, "flash_bwd_f32": fa.flash_bwd_f32_cuda,
            "ce_fwd": fc.ce_forward, "adamw": fw.fused_adamw,
            "flash_general_fwd": fa.flash_general_forward, "flash_rowdot": fa.flash_rowdot,
            "flash_general_dq": fa.flash_general_dq, "flash_general_dkv": fa.flash_general_dkv,
            "flash_lse_fwd": fa.flash_lse_forward, "flash_fused_bwd": fa.flash_fused_backward,
            "flash_general_fwd_f32": fa.flash_general_forward_f32,
            "flash_general_bwd_f32": fa.flash_general_backward_f32,
            "flash_rowdot_f32": fa.flash_rowdot_f32,
            "flash_lse_fwd_f32": fa.flash_lse_forward_f32,
            "flash_fused_bwd_f32": fa.flash_fused_backward_f32}


def read_counts() -> dict:
    return {n: int(f.launches) for n, f in kernel_counters().items()}


class FaultySync(GradSync):
    """A GradSync with one deliberate fault, for the controls that must fail
    their checks: ``"skip_allreduce"`` leaves the grads unreduced,
    ``"count_replicated"`` counts every leaf as split in the clip norm (a
    replicated leaf's squares summed over ``model``, so tp times, and under
    the pipeline over ``pipe``, once per stage)."""

    def __init__(self, mesh, *, fault: str, **kw):
        if fault not in ("skip_allreduce", "count_replicated"):
            raise ValueError(f"unknown fault {fault!r}")
        super().__init__(mesh, **kw)
        self.fault = fault

    def reduce_(self, grads):
        if self.fault != "skip_allreduce":
            super().reduce_(grads)

    def norm(self, grads):
        if self.fault == "count_replicated":
            self.sharded = set(grads)
            if self.staged is not None:
                self.staged = set(grads)
        return super().norm(grads)


def faulty_pipeline(pipe):
    """The pipeline control: the backward hop dropped (each stage's input
    cotangent is never sent and the stage before takes zeros), so every
    stage but the last forms its grads from nothing."""
    from ..parallel.pipeline import Pipeline

    class Dropped(Pipeline):
        def send_cotangent(self, g):
            pass

        def recv_cotangent(self, like):
            return torch.zeros_like(like)

    out = object.__new__(Dropped)
    out.__dict__.update(pipe.__dict__)
    return out


def faulty_placement(placement):
    """The 8-bit moments' control: each rank requantizes its own part of a
    leaf on a grid of its own (the per-shard grid JAX ``moment_specs``
    rejects), wherever that part fills its slice's buffers."""
    from ..parallel.sharding import Placement
    from ..train.optimizer import _q8_update, jax_leaves

    class PerShard(Placement):
        def update_q8(self, path, params, grads, mq, vq, *args):
            local = jax_leaves({n: params[n] for n in self.leaves[path].names
                                if n in params})[path]
            if -(-local.size // 256) * 256 == mq["q"].numel() and local.size != self.leaves[path].size:
                _q8_update(local, params, grads, mq, vq, *args)
            else:
                super().update_q8(path, params, grads, mq, vq, *args)

    out = object.__new__(PerShard)
    out.__dict__.update(placement.__dict__)
    return out


RING_FAULTS = ("a2a_identity_backward", "drop_merge_weights")


@contextlib.contextmanager
def faulty_ring(fault: str):
    """The ring's controls, for the ranks of one run: ``"a2a_identity_backward"``
    takes the backward of each all-to-all of the swap around the ring as the
    identity on the rank's own block (its chunk of its heads, zeros for the
    rest: no exchange), ``"drop_merge_weights"`` merges the ring's partial
    outputs without their softmax weights."""
    from ..ops import ring_attention as ra
    from ..parallel import collectives as coll

    def own_block(g, group, heads, to_chunks):
        """The cotangent's block of this rank alone, in the input's layout."""
        r, n = coll._rank(group), coll._size(group)
        h0 = sum(heads[:r])
        if to_chunks:  # g: (B, T, ..., h_r, hs) -> (B, T / n, ..., H, hs)
            tc = g.shape[1] // n
            out = g.new_zeros((g.shape[0], tc, *g.shape[2:-2], sum(heads), g.shape[-1]))
            out[..., h0:h0 + heads[r], :] = g[:, r * tc:(r + 1) * tc]
        else:  # g: (B, T / n, ..., H, hs) -> (B, T, ..., h_r, hs)
            tc = g.shape[1]
            out = g.new_zeros((g.shape[0], tc * n, *g.shape[2:-2], heads[r], g.shape[-1]))
            out[:, r * tc:(r + 1) * tc] = g[..., h0:h0 + heads[r], :]
        return out

    saved = (coll.HeadsToChunks.backward, coll.ChunksToHeads.backward, ra._merge)
    if fault == "a2a_identity_backward":
        coll.HeadsToChunks.backward = staticmethod(
            lambda ctx, g: (own_block(g, ctx.group, ctx.heads, False), None, None))
        coll.ChunksToHeads.backward = staticmethod(
            lambda ctx, g: (own_block(g, ctx.group, ctx.heads, True), None, None))
    elif fault == "drop_merge_weights":
        ra._merge = lambda c, u: (c[0] + u[0], torch.logaddexp(c[1], u[1]))
    try:
        yield
    finally:
        coll.HeadsToChunks.backward, coll.ChunksToHeads.backward = (
            staticmethod(saved[0]), staticmethod(saved[1]))
        ra._merge = saved[2]


# ---------------------------------------------------------------------------
# "step"
# ---------------------------------------------------------------------------


def _whole_model(job, cfg, device):
    from ..models import gpt2

    model = gpt2.init(cfg, generator=torch.Generator(device).manual_seed(job.get("seed", 0)),
                      device=device)
    if job.get("init"):
        model.load_state_dict(torch.load(job["init"], map_location=device, weights_only=True))
    return model


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


SYNC_FAULTS = ("skip_allreduce", "count_replicated")


def _make_sync(job):
    """The GradSync factory of a job: ``FaultySync`` with the job's ``fault``,
    or None (``GradSync`` itself)."""
    if job.get("fault") in SYNC_FAULTS:
        return functools.partial(FaultySync, fault=job["fault"])
    return None


def _grad_sync(job, mesh, **kw):
    return None if mesh.world == 1 else (_make_sync(job) or GradSync)(mesh, **kw)


def _steps(job: dict, device, mesh):
    """The train steps of a ``"step"`` job on ``mesh``; returns (record, whole
    tensors {"before", "after", "grads"} on this rank, gathered where the
    rank holds part of the model, and {"q8"} the whole 8-bit moments)."""
    from ..models import gpt2
    from ..ops import ring_attention
    from ..parallel import collectives as coll
    from ..parallel.pipeline import make_pipeline_loss_fn
    from ..parallel.sharding import setup_parallel
    from ..train.optimizer import adamw_init
    from ..train.step import make_train_step
    from ..utils.trees import tree_bytes

    data, n_model, n_pipe = mesh.size("data"), mesh.size("model"), mesh.size("pipe")
    cfg = GPTConfig(**job["model"])
    policy = _policy(job)
    ring = bool(job.get("ring"))
    fault = job.get("fault")
    if fault and fault not in SYNC_FAULTS + RING_FAULTS + ("drop_backward_hop", "per_shard_q8"):
        raise ValueError(f"unknown fault {fault!r}")
    model = _whole_model(job, cfg, device)
    whole_bytes = tree_bytes(dict(model.named_parameters()))
    placement, sync = setup_parallel(model, mesh, seq_parallel=bool(job.get("seq_parallel")),
                                     make_sync=_make_sync(job))
    if fault == "per_shard_q8":
        placement = faulty_placement(placement)
    reduced = {}  # the step's reduced grads (the pipeline folds them into accumulators)
    if sync is not None:
        reduce_ = sync.reduce_

        def keep(grads):
            reduce_(grads)
            reduced.clear()
            reduced.update(grads)

        sync.reduce_ = keep
    params = gpt2.named_params(model)
    rows = np.load(job["rows"])  # (steps, accum, B, T + 1), the global batch
    if mesh.world == 1 and job.get("data_split", 1) > 1:
        # the one-process step of a data-parallel job's batch: each of its
        # micro-batches as data_split micro-batches of the ranks' rows
        k = job["data_split"]
        s_, a_, b_, t_ = rows.shape
        rows = rows.reshape(s_, a_ * k, b_ // k, t_)
    steps, accum, b_all, t1 = rows.shape
    b = b_all // data
    d = mesh.coord("data")
    rows = rows[:, :, d * b:(d + 1) * b]
    t = t1 - 1
    attn_impl = "ring" if ring else job.get("attn_impl", "auto")
    layerwise = None
    local_ring = ring and n_model == 1  # one process: a LocalRing of ring_size chunks
    if local_ring:
        ring_attention.set_ring(job.get("ring_size", n_model))
    if n_pipe > 1:  # the GPipe schedule, through the train step's layerwise seam
        pipe = make_pipeline_loss_fn(cfg, mesh, n_micro=job.get("pp_micro") or n_pipe,
                                     policy=policy, attn_impl=attn_impl)
        if fault == "drop_backward_hop":
            pipe = faulty_pipeline(pipe)

        def loss_fn(m, micro):
            return pipe.loss(m, {"x": micro[:, :-1], "y": micro[:, 1:]})

        def layerwise(m, micro, acc):
            return pipe.loss_grad(m, {"x": micro[:, :-1], "y": micro[:, 1:]}, acc)
    else:
        def loss_fn(m, micro):
            return gpt2.loss(m, micro[:, :-1], cfg, targets=micro[:, 1:], policy=policy,
                             attn_impl=attn_impl, remat=job.get("remat", False))

    held = {}  # the layerwise step's accumulators: its grads where no GradSync sees them
    if job.get("layerwise"):
        def layerwise(m, micro, acc):
            held["acc"] = acc
            return gpt2.loss_grad_layerwise(m, micro[:, :-1], cfg, targets=micro[:, 1:],
                                            acc=acc, policy=policy, attn_impl=attn_impl,
                                            ce_chunks=2)

    opt_cfg = OptimizerConfig(**job.get("opt", {}))
    step = make_train_step(loss_fn, opt_cfg, ScheduleConfig(**job.get("sched", {})),
                           decay_mask=gpt2.decay_mask(model), layerwise_loss_grad=layerwise,
                           grad_sync=sync, placement=placement)
    state = adamw_init(params, state_dtype=job.get("opt_state_dtype"), placement=placement)
    before = {n: v.detach().clone() for n, v in placement.whole(dict(params)).items()}
    step0 = int(job.get("step0", 0))
    rec = {"rank": mesh.rank, "world": mesh.world, "mesh": list(mesh.shape),
           "axes": list(mesh.axis_names), "accum": accum,
           "local_heads": gpt2.local_heads(model, cfg), "tokens_per_step": accum * b_all * t,
           "param_bytes": tree_bytes(dict(params)), "whole_param_bytes": whole_bytes,
           "param_shapes": {n: list(p.shape) for n, p in params.items()},
           "moment_bytes": tree_bytes([state["m"], state["v"]])}
    if placement.stage is not None:
        rec["stage_layers"] = list(placement.stage.layers)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    staged0 = coll.host_staged.calls
    if job.get("eval"):  # one no-grad micro-batch: the validation path (the CE kernel)
        batch = torch.from_numpy(rows[0][0].astype(np.int64)).to(device)
        c0 = read_counts()
        with torch.no_grad():
            rec["eval_loss"] = float(loss_fn(model, batch))
        rec["eval_counts"] = {k: v - c0[k] for k, v in read_counts().items()}
    metrics, seconds = [], []
    counts0, calls0 = read_counts(), dict(coll.counts)
    staged_steps0 = coll.host_staged.calls
    with faulty_ring(fault) if fault in RING_FAULTS else contextlib.nullcontext():
        for i in range(steps):
            batch = torch.from_numpy(rows[i].astype(np.int64)).to(device)
            _sync(device)
            t0 = time.perf_counter()
            metrics.append(step(model, state, batch, step0 + i))
            _sync(device)
            seconds.append(time.perf_counter() - t0)
    counts = {k: v - counts0[k] for k, v in read_counts().items()}
    grads = reduced or (held["acc"].sums if held else
                        {n: p.grad for n, p in params.items() if p.grad is not None})
    rec.update(metrics=metrics, seconds=seconds, launch_counts=counts,
               host_staged=coll.host_staged.calls - staged0,
               host_staged_per_step=(coll.host_staged.calls - staged_steps0) / steps,
               collectives={k: (v - calls0.get(k, 0)) / steps for k, v in coll.counts.items()
                            if v - calls0.get(k, 0)},
               grad_allreduces=0 if sync is None else sync.calls,
               peak_gib=(torch.cuda.max_memory_allocated(device) / 2 ** 30
                         if device.type == "cuda" else None))
    out = {"before": before,
           "after": {n: v.detach() for n, v in placement.whole(dict(params)).items()},
           "grads": {n: v.detach() for n, v in placement.whole(grads).items()} if grads else {}}
    out["q8"] = {f"{mv}:{path}:{k}": a for mv in ("m", "v")
                 for path, d_ in placement.whole(state[mv]).items() if isinstance(d_, dict)
                 for k, a in d_.items()}
    rec["opt_steps"] = state["step"]
    # ``repeat``: the last step run again that many times after the readings
    # were taken, timed alone (the first step of a process is cold)
    warm = []
    if job.get("repeat"):
        out = {k: {n: v.detach().clone() for n, v in d.items()} for k, d in out.items()}
    for _ in range(int(job.get("repeat", 0))):
        _sync(device)
        t0 = time.perf_counter()
        step(model, state, batch, step0 + steps - 1)
        _sync(device)
        warm.append(time.perf_counter() - t0)
    rec["warm_seconds"] = warm
    if local_ring:
        ring_attention.set_ring(None)
    return rec, out
def _rel_l2(a: dict, b: dict) -> float:
    num = sum(float((a[n].double() - b[n].double()).square().sum()) for n in b)
    den = sum(float(b[n].double().square().sum()) for n in b)
    return (num / den) ** 0.5


def compare_steps(rec, got, ref_rec, ref, opt_cfg, decay_mask, trainable=None) -> dict:
    """The readings a run over processes is held to against the one-process
    step from the same state on the same rows (the last step of each):

      * loss_abs, grad_norm_rel: the two steps' metrics;
      * grads_rel_l2: the whole gradients, each times its 1/accum;
      * norm_self_rel: the step's clip norm against the norm of its own whole
        gradients (a norm counting a replicated leaf more than once is off);
      * update_max_rel: the step's parameter change against the plain AdamW
        replayed on its own whole gradients from the same state, as
        max|err| / max|ref|.

    Computed on the device of ``got``'s tensors (``ref``'s are moved
    there)."""
    from ..train.optimizer import adamw_init, adamw_update, global_norm

    m, r = rec["metrics"][-1], ref_rec["metrics"][-1]
    inv, inv_ref = 1.0 / rec["accum"], 1.0 / ref_rec["accum"]
    names = [n for n in ref["grads"] if trainable is None or trainable[n]]
    dev = got["grads"][names[0]].device
    g = {n: got["grads"][n].float() * inv for n in names}
    g_ref = {n: ref["grads"][n].to(dev).float() * inv_ref for n in names}
    own_norm = float(global_norm(g))
    p = {n: got["before"][n].clone() for n in names}
    st = adamw_init(p)
    norm_t = torch.tensor(own_norm, dtype=torch.float32, device=next(iter(p.values())).device)
    adamw_update(p, {n: got["grads"][n].float() for n in names}, st, m["lr"], opt_cfg,
                 norm=norm_t, decay_mask=decay_mask, use_fused=False, grad_scale=inv)
    delta = {n: got["after"][n].float() - got["before"][n].float() for n in names}
    want = {n: p[n] - got["before"][n].float() for n in names}
    top = max(float(w.abs().max()) for w in want.values())
    out = {"loss_abs": abs(m["loss"] - r["loss"]),
           "grad_norm_rel": abs(m["grad_norm"] - r["grad_norm"]) / r["grad_norm"],
           "grads_rel_l2": _rel_l2(g, g_ref),
           "norm_self_rel": abs(m["grad_norm"] - own_norm) / own_norm,
           "update_max_rel": max(float((delta[n] - want[n]).abs().max()) for n in names) / top}
    if "eval_loss" in rec:
        out["eval_abs"] = abs(rec["eval_loss"] - ref_rec["eval_loss"])
    return out


# JAX test_pipeline_int8_moments_parity's tolerances (tests/test_pipeline.py:
# 283-292 there): loss rtol 2e-5, grad norm rtol 1e-3, params rtol 2e-4 with
# an atol of one quantization step (``compare_q8``)
Q8_RTOL = {"loss": 2e-5, "grad_norm": 1e-3, "params": 2e-4}


def compare_q8(rec, got, ref_rec, ref, opt_cfg, cfg) -> dict:
    """The readings an int8-moment run over processes is held to against the
    one-process int8 run from the same state on the same rows (after the
    last step of each; JAX ``test_pipeline_int8_moments_parity``):

      * loss_rel, grad_norm_rel: the two steps' metrics;
      * params_outside: the elements of the 8-bit leaves' parameters off by
        more than 2e-4 relative plus one quantization step, the change one
        code of m makes to the element's update at the last step (lr times
        the block's m scale over bc1, over the element's sqrt(v) over
        sqrt(bc2) + eps, from the one-process run's final codes);
      * codes_differ: the share of the 8-bit codes of m and v that differ
        from the one-process run's (the block grid taken over the whole JAX
        leaf makes them equal but where fp32 rounding moved a value across a
        rounding boundary, or moved the scale of a block of near-zero
        gradients; ``q8_detail`` has them leaf by leaf)."""
    m, r = rec["metrics"][-1], ref_rec["metrics"][-1]
    out = {"loss_rel": abs(m["loss"] - r["loss"]) / abs(r["loss"]),
           "grad_norm_rel": abs(m["grad_norm"] - r["grad_norm"]) / r["grad_norm"]}
    detail = q8_detail(got["q8"], ref["q8"])
    n_codes = sum(d["codes"] for k, d in detail.items() if k.endswith(":q"))
    out["codes_differ"] = (sum(d["differ"] for k, d in detail.items() if k.endswith(":q"))
                           / max(n_codes, 1))
    moments = {mv: {path: {k: ref["q8"][f"{mv}:{path}:{k}"] for k in ("q", "s")}
                    for path in {key.split(":")[1] for key in ref["q8"]}} for mv in ("m", "v")}
    out["params_outside"] = sum(q8_outside(got["after"], ref["after"], moments, m["lr"],
                                           ref_rec["opt_steps"], opt_cfg).values())
    return out


def q8_detail(got: dict, ref: dict) -> dict:
    """"m:path:q" / "v:path:s" -> how the 8-bit buffers differ from the
    reference's: codes (count, differing, the largest difference) and
    scales (the largest relative difference, the reference's scale there)."""
    out = {}
    for key, b in ref.items():
        a = got[key]
        if key.endswith(":q"):
            d = (a.int() - b.int()).abs()
            out[key] = {"codes": d.numel(), "differ": int((d > 0).sum()), "max_diff": int(d.max())}
        else:
            rel = (a - b).abs() / b.abs()
            i = int(rel.argmax())
            out[key] = {"max_rel": float(rel[i]), "at_block": i, "ref_scale": float(b[i]),
                        "scale": float(a[i])}
    return out


def q8_outside(got: dict, want: dict, moments: dict, lr: float, steps: int, opt_cfg,
               rtol: float = Q8_RTOL["params"]) -> dict:
    """JAX path -> the elements of the 8-bit leaf's parameters (whole trees
    keyed by name) off by more than ``rtol`` relative plus one quantization
    step: the change one code of m makes to the element's update at the
    last step, lr times the block's m scale over bc1, over the element's
    sqrt(v) over sqrt(bc2) + eps, read off ``moments`` ({"m", "v"}: JAX path
    -> {q, s}, the reference's codes after its ``steps`` updates)."""
    from ..train.optimizer import Q8_BLOCK, jax_leaves, q8_dequantize

    bc1 = 1.0 - opt_cfg.beta1 ** steps
    bc2 = 1.0 - opt_cfg.beta2 ** steps
    out = {}
    for path, leaf in jax_leaves(want).items():
        if path not in moments["m"]:
            continue
        mq, vq = moments["m"][path], moments["v"][path]
        s_m = mq["s"].repeat_interleave(Q8_BLOCK)[:leaf.size]
        r_hat = q8_dequantize(vq, (leaf.size,))
        step_q = lr * (s_m / bc1) / (r_hat / bc2 ** 0.5 + opt_cfg.eps)
        a = leaf.gather(want, 0, leaf.shape[0])
        b = leaf.gather(got, 0, leaf.shape[0])
        out[path] = int(((b - a).abs() > rtol * a.abs() + step_q).sum())
    return out


_REFERENCES = {}


def _reference(job, device, run):
    """rank 0's one-process run of ``job`` (cached by job: several jobs of a
    list share one), its whole tensors on the host."""
    key = json.dumps({k: v for k, v in job.items() if k not in ("tag", "mesh")}, sort_keys=True)
    if key not in _REFERENCES:
        from ..parallel.mesh import Mesh

        rec, out = run(job, device, Mesh(("data", "model"), (1, 1)))
        _REFERENCES[key] = rec, {k: {n: v.cpu() for n, v in d.items()} for k, d in out.items()}
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return _REFERENCES[key]


def run_step_job(job: dict) -> dict:
    """The train steps of a ``"step"`` job on this rank; returns its record.
    ``reference``: rank 0 first runs the one-process step on the same rows
    from the same state and adds ``compare_steps``'s ``errors``. Rank 0 also
    writes its whole tensors with ``out`` and ``save_whole``."""
    import torch.distributed as dist

    from ..models import gpt2
    from ..parallel.mesh import init_distributed, make_mesh

    device = init_distributed(_device(job))
    data, n_model = job.get("mesh", [1, 1])
    pp = int(job.get("pp", 1))
    ref = None
    rank = dist.get_rank() if dist.is_initialized() else 0
    if job.get("reference") and rank == 0:
        # the same rows from the same state on one process: every data rank's
        # rows in turn, the ring (if any) run in turn, the validation
        # micro-batch scored
        rjob = {k: v for k, v in job.items()
                if k not in ("fault", "seq_parallel", "pp", "pp_micro")}
        rjob.update(data_split=data, eval=True)
        if job.get("ring"):
            rjob["ring_size"] = n_model
        ref = _reference(rjob, device, _steps)
    if dist.is_initialized():
        dist.barrier()
    if pp > 1:
        mesh = make_mesh(None, ("data", "pipe", "model"), (data, pp, n_model))
    else:
        mesh = make_mesh(None, ("data", "model"), (data, n_model))
    rec, out = _steps(job, device, mesh)
    if ref is not None:
        rec["reference"] = {k: ref[0][k] for k in ("seconds", "warm_seconds", "peak_gib",
                                                   "tokens_per_step", "param_bytes",
                                                   "moment_bytes")}
        cfg = GPTConfig(**job["model"])
        opt_cfg = OptimizerConfig(**job.get("opt", {}))
        if job.get("opt_state_dtype") == "int8":
            got = {k: {n: v.cpu() for n, v in d.items()} for k, d in out.items()}
            rec["errors"] = compare_q8(rec, got, ref[0], ref[1], opt_cfg, cfg)
            rec["q8_detail"] = q8_detail(got["q8"], ref[1]["q8"])
        else:  # on this rank's device, the host's fp32 replay of a whole model being slow
            with torch.device("meta"):  # the mask's names alone
                decay = gpt2.decay_mask(gpt2.GPT2(cfg))
            rec["errors"] = compare_steps(rec, out, ref[0], ref[1], opt_cfg, decay)
    if mesh.rank == 0 and job.get("out") and job.get("save_whole", True):
        torch.save({k: {n: v.cpu() for n, v in d.items()} for k, d in out.items()},
                   os.path.join(job["out"], f"{job.get('tag', 'step')}_whole.pt"))
    return rec


# ---------------------------------------------------------------------------
# "ftstep": one optimizer step of a caption fine-tune
# ---------------------------------------------------------------------------


def _ft_steps(job: dict, device, mesh):
    """One step of the preset fine-tune ``job["bridge"]`` at ``n_layer``
    layers, data-parallel over ``mesh``: a seeded synthetic window of
    ``accum`` micro-batches of ``b`` rows (the global batch; data rank d
    takes rows d, d + W, ..., the striding of data/coco.CocoBatcher), the
    training loss with the Q-Former's dropout drawn for the global batch."""
    from ..core import config as port_config
    from ..models import gpt2
    from ..parallel import collectives as coll
    from ..train import finetune
    from ..train.optimizer import adamw_init
    from ..train.step import make_train_step

    kind = job["bridge"]
    preset = getattr(port_config, f"finetune_{kind}_preset")()
    preset = dataclasses.replace(preset, model=preset.model.replace(n_layer=job["n_layer"]))
    policy = _policy(job)
    world = mesh.size("data")
    parts = finetune.build_finetune(preset, device=device, policy=policy,
                                    mesh=mesh if world > 1 else None)
    model, trainable, decay = parts["model"], parts["trainable"], parts["decay"]
    rng = np.random.RandomState(job.get("seed", 0))
    accum, b, t, n_bank = job["accum"], job["b"], job["t"], job["n_bank"]
    bank = torch.from_numpy(rng.randn(n_bank, 33, preset.model.img_embd
                                      if kind == "xattn" else preset.bridge.enc_dim)
                            .astype(np.float32)).to(device, policy.compute_dtype)
    toks = rng.randint(0, 50257, (accum, b, t + 1))
    lens = rng.randint(4, t, (accum, b, 1))
    mask = np.arange(t)[None, None, :] < lens
    idx = rng.randint(0, n_bank, (accum, b))
    d = mesh.coord("data")
    batch = {k: torch.from_numpy(np.ascontiguousarray(v[:, d::world])).to(device)
             for k, v in (("x", toks[..., :-1]), ("y", toks[..., 1:]), ("mask", mask),
                          ("idx", idx))}
    if parts["dropout"]:
        batch["seed"] = finetune.dropout_seeds(preset.seed, 0, accum)
    sync = _grad_sync(job, mesh, loss_is_global=True)
    sched = dataclasses.replace(preset.schedule, warmup_steps=0)  # step 0 at the peak LR
    step = make_train_step(parts["train_loss_fn"], preset.optimizer, sched, decay_mask=decay,
                           trainable_mask=trainable, grad_sync=sync)
    params = gpt2.named_params(model)
    state = adamw_init(params, trainable_mask=trainable)
    before = {n: p.detach().clone() for n, p in params.items() if trainable[n]}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    counts0, staged0 = read_counts(), coll.host_staged.calls
    _sync(device)
    t0 = time.perf_counter()
    metrics = step(model, state, batch, 0, bank)
    _sync(device)
    rec = {"rank": mesh.rank, "world": mesh.world, "accum": accum, "metrics": [metrics],
           "seconds": [time.perf_counter() - t0],
           "launch_counts": {k: v - counts0[k] for k, v in read_counts().items()},
           "host_staged": coll.host_staged.calls - staged0, "tokens_per_step": accum * b * t,
           "peak_gib": (torch.cuda.max_memory_allocated(device) / 2 ** 30
                        if device.type == "cuda" else None)}
    out = {"before": before,
           "after": {n: p.detach().clone() for n, p in params.items() if trainable[n]},
           "grads": {n: p.grad.detach().clone() for n, p in params.items()
                     if trainable[n] and p.grad is not None}}
    return rec, out, (preset.optimizer, decay, trainable)


def run_ft_step_job(job: dict) -> dict:
    """``"ftstep"``: rank 0 runs the one-process step first (``reference``)
    and adds the readings of ``compare_steps`` over the trainable leaves."""
    import torch.distributed as dist

    from ..parallel.mesh import init_distributed, make_mesh

    device = init_distributed(_device(job))
    world = job.get("mesh", [1])[0]
    ref = None
    rank = dist.get_rank() if dist.is_initialized() else 0
    if job.get("reference") and rank == 0:
        def one(j, dev, mesh):
            rec, out, _ = _ft_steps(j, dev, mesh)
            return rec, out

        ref = _reference(dict(job, mesh=[1]), device, one)
    if dist.is_initialized():
        dist.barrier()
    rec, out, (opt_cfg, decay, trainable) = _ft_steps(job, device,
                                                       make_mesh(None, ("data",), (world,)))
    if ref is not None:
        rec["errors"] = compare_steps(rec, out, ref[0], ref[1], opt_cfg, decay, trainable)
    return rec


# ---------------------------------------------------------------------------
# "pretrain" / "finetune"
# ---------------------------------------------------------------------------


def _pretrain_cfg(job) -> PretrainConfig:
    c = dict(job["pretrain"])
    c["model"] = GPTConfig(**job["model"])
    c["schedule"] = ScheduleConfig(**c.pop("schedule", {}))
    if "optimizer" in c:
        c["optimizer"] = OptimizerConfig(**c["optimizer"])
    return PretrainConfig(**c)


def _finetune_cfg(job) -> FinetuneConfig:
    c = dict(job["finetune"])
    c["model"] = GPTConfig(**job["model"])
    c["bridge"] = BridgeConfig(**c.pop("bridge"))
    c["schedule"] = ScheduleConfig(**c.pop("schedule", {}))
    if "optimizer" in c:
        c["optimizer"] = OptimizerConfig(**c["optimizer"])
    return FinetuneConfig(**c)


def _param_sums(model) -> dict:
    from ..models import gpt2

    out = {}
    for n, p in gpt2.named_params(model).items():
        a = p.detach().double()
        out[n] = [float(a.sum()), float(a.abs().sum())]
    return out


def run_trainer_job(job: dict) -> dict:
    """A ``"pretrain"``, ``"finetune"`` or ``"cli"`` job: the trainer's run, and
    this rank's launch counts over it."""
    from ..parallel import collectives as coll
    from ..parallel.mesh import world_size
    from ..train.finetune import run_finetune
    from ..train.pretrain import run_pretrain

    if job.get("hellaswag_dir"):
        os.environ["HELLASWAG_DIR"] = job["hellaswag_dir"]
    counts0, staged0 = read_counts(), coll.host_staged.calls
    t0 = time.perf_counter()
    if job["kind"] == "cli":
        from ..cli.pretrain import main as pretrain_main

        out = pretrain_main(job["argv"],
                            model=GPTConfig(**job["model"]) if job.get("model") else None)
    elif job["kind"] == "pretrain":
        out = run_pretrain(_pretrain_cfg(job), device=_device(job), policy=_policy(job),
                           max_steps_override=job.get("max_steps"),
                           num_devices=job.get("devices"))
    else:
        out = run_finetune(_finetune_cfg(job), device=_device(job), policy=_policy(job),
                           max_steps_override=job.get("max_steps"),
                           num_devices=job.get("devices"))
    import torch.distributed as dist

    rank = dist.get_rank() if dist.is_initialized() else 0
    return {"rank": rank, "world": world_size(), "val_loss": out["val_loss"],
            "cider": out.get("cider"), "step": out["opt_state"]["step"],
            "param_sums": _param_sums(out["model"]),
            "launch_counts": {k: v - counts0[k] for k, v in read_counts().items()},
            "host_staged": coll.host_staged.calls - staged0,
            "seconds": time.perf_counter() - t0}


def run_job(job: dict) -> dict:
    """Run one job, or each of a ``"jobs"`` list in turn in the same
    processes (the list's own keys are every job's defaults; kind "step")."""
    torch.set_num_threads(int(job.get("threads", 1)))
    if job["kind"] == "jobs":
        base = {k: v for k, v in job.items() if k not in ("kind", "jobs")}
        return [run_job({"kind": "step", **base, **j}) for j in job["jobs"]]
    runners = {"step": run_step_job, "ftstep": run_ft_step_job}
    t0 = time.perf_counter()
    rec = runners.get(job["kind"], run_trainer_job)(job)
    rec["wall_s"] = time.perf_counter() - t0  # the job's, its reference included
    if job.get("out"):
        path = os.path.join(job["out"], f"{job.get('tag', job['kind'])}_r{rec['rank']}.json")
        with open(path, "w") as f:
            json.dump(rec, f)
    return rec


# ---------------------------------------------------------------------------
# Launching
# ---------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(job: dict, nprocs: int, *, timeout: float, workdir: str, argv=None) -> list:
    """Run ``job`` (written to ``workdir``) in ``nprocs`` worker processes, the
    variables of torch.distributed.run set for each, one torch thread each
    unless the job says otherwise. ``argv`` replaces the worker's module
    command (e.g. a CLI's ``-m`` and arguments). Kills every process at
    ``timeout`` seconds and raises with the logs if any rank failed. Returns
    each rank's log text."""
    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, f"{job.get('tag', job.get('kind', 'job'))}.json")
    with open(path, "w") as f:
        json.dump(job, f)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    port = free_port()
    cmd = argv or ["-m", "gpt2_vision_language_tpu_torch.tools.dist_worker", path]
    procs, logs = [], []
    for r in range(nprocs):
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(r),
                   WORLD_SIZE=str(nprocs), LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(nprocs),
                   OMP_NUM_THREADS=str(job.get("threads", 1)),
                   PYTHONPATH=os.pathsep.join([root, os.environ.get("PYTHONPATH", "")]))
        log = open(os.path.join(workdir, f"{job.get('tag', 'job')}_log{r}.txt"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen([sys.executable, *cmd], env=env, cwd=root,
                                      stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for log in logs:
        log.seek(0)
        texts.append(log.read())
        log.close()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(f"ranks failed (rank, exit code) {bad}:\n" + "\n".join(
            f"--- rank {r} ---\n{texts[r][-6000:]}" for r, _ in bad))
    return texts


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    with open(argv[0]) as f:
        job = json.load(f)
    run_job(job)
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
