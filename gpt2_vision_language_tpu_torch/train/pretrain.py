"""FineWeb-Edu GPT-2 pretraining workload, on one device or over processes.

Counterpart of gpt2_vision_language_tpu/train/pretrain.py:44-466: the
reference's cadences (val every 250, samples every 250,
rolling checkpoint every 2500, auto-resume), its CSV schema and its
hyperparameters through ``PretrainConfig``. The token shards are read by
``data/fineweb.TokenShardLoader`` and the CSV is written by
``obs/csvlog.MetricsLogger``, the port's own copies of the JAX package's host
modules; with ``$PROFILE_DIR`` set, ``obs/csvlog.ProfilerHook`` writes a
torch.profiler trace of steps 11-15 there, the JAX trainer's window. Each
step's (accum, B, T+1) uint16 row buffer is read and copied to
the device by a background thread (``data/pipeline.HostPrefetcher``: the next
window is on its way while the current step runs), in its 16 bits through
pinned memory, and split into x, y and widened to int32 there, as the JAX
trainer does (``split_rows_on_device``). HellaSwag runs every
``hellaswag_every`` steps and at the last step when ``run_hellaswag`` is set
and ``$HELLASWAG_DIR`` (default ``./hellaswag``) is a directory.

Parallel styles (JAX :44-140, 200-230). Launched by ``python -m
torch.distributed.run``, the ranks form a ("data", "model") mesh of shape
(world / tp, tp), or with ``pp > 1`` a ("data", "pipe"[, "model"]) mesh of
shape (world / (pp * tp), pp[, tp]) (parallel/mesh.py):

  * data parallelism over ``data``: each data rank reads its stride of the
    rows (``TokenShardLoader(rank, world_size)``), the accumulated grads are
    all-reduced once a step and the losses averaged
    (parallel/collectives.GradSync); ``grad_accum_steps`` divides the global
    batch over the data ranks;
  * ``tp > 1``: Megatron tensor parallelism over ``model``
    (parallel/sharding.py), the ranks of one model group reading the same
    rows; with ``seq_parallel`` the residual stream T-sharded between
    blocks;
  * ``attn_impl="ring"`` (:88-96, :134-138 there) with ``tp > 1`` chunks
    that divide ``seq_len``: over processes, the Megatron placement above
    (JAX ``shard_params`` / ``shard_moments`` split over "model" whatever
    the attention), each attention swapping its heads for a T/tp chunk of
    every head and running the ring over the model group
    (``parallel/sharding.TensorParallel.ring_attention``), with
    ``seq_parallel`` or ``layerwise_grad`` as under TP; on one process the
    ring is run in turn (``ops.ring_attention.LocalRing``), installed before
    the first step and removed when the run ends;
  * ``pp > 1``: the GPipe pipeline over ``pipe`` (parallel/pipeline.py), a
    stage of n_layer / pp layers a rank, ``pp_micro`` (or pp) sub-batches a
    micro-batch; each step through the train step's layerwise seam,
    validation through the schedule's forward (K4 on the last stage);
    HellaSwag and sampling on the model with every stage's layers gathered
    (``whole_stages``, its cost printed). With ``tp > 1`` as well, each
    stage's layers are cut Megatron-style over ``model``.

8-bit moments under TP and PP keep the one-process block grid over the whole
JAX leaf, each rank a slice of the codes (parallel/sharding.Placement).

Only the master writes the CSV and the checkpoints (gathered whole trees,
whole 8-bit buffers too, as one process writes them; every rank reads them
on resume and keeps its part), HellaSwag examples go
round-robin over the data ranks with their counts summed, and sampling is
seeded ``42 + data rank`` (the ranks of one model group draw the same
tokens).

The big-model memory recipes are the JAX ones (:164-171, :208-212,
:253-272, :309-325 there): ``param_dtype`` casts the params at init and
again on a resume, ``opt_state_dtype`` picks the moments' storage (and a
resumed state is converted to it, ``convert_moments``), ``grad_accum_dtype``
the accumulators', ``layerwise_grad`` forms each micro-batch's grads layer
by layer (``models.gpt2.loss_grad_layerwise``), and ``remat`` is
``run_blocks``'. A ``[mem]`` line prints the state's bytes
(``utils/trees``).
"""

from __future__ import annotations

import contextlib
import math
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from ..ckpt.checkpoint import CheckpointManager
from ..core.config import PretrainConfig
from ..core.precision import Policy, DEFAULT_POLICY
from ..data.fineweb import TokenShardLoader
from ..data.pipeline import HostPrefetcher
from ..data.tokenizer import get_tokenizer
from ..eval.hellaswag import HellaSwagEvaluator
from ..infer.decode import Decoder
from ..infer.sampling import sample_top_k
from ..models import gpt2
from ..obs.csvlog import MetricsLogger, ProfilerHook
from ..obs.spans import span
from ..ops import ring_attention
from ..parallel import collectives as coll
from ..parallel.mesh import init_distributed, is_master, make_mesh, world_size
from ..parallel.pipeline import make_pipeline_loss_fn, whole_stages
from ..parallel.sharding import setup_parallel
from ..utils.trees import fmt_count, tree_bytes
from .optimizer import adamw_init, convert_moments
from .step import make_eval_step, make_train_step

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def upload_rows(rows: np.ndarray, device: torch.device) -> torch.Tensor:
    """(..., B, T+1) uint16 token rows -> the same 16 bits on ``device``, as
    an int16 tensor (through pinned memory for a CUDA device): half the bytes
    of int32 rows."""
    t = torch.from_numpy(np.ascontiguousarray(rows, dtype=np.uint16).view(np.int16))
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def split_rows_on_device(rows: torch.Tensor) -> dict:
    """Rows from ``upload_rows`` -> {"x": rows[..., :-1], "y": rows[..., 1:]},
    widened to int32 on the rows' device (the port's counterpart of
    gpt2_vision_language_tpu/data/fineweb.py split_rows_on_device); span
    ``data.split``."""
    with span("data.split"):
        wide = rows.to(torch.int32) & 0xFFFF
        return {"x": wide[..., :-1], "y": wide[..., 1:]}


def check_parallel(cfg: PretrainConfig, world: Optional[int] = None) -> None:
    """Raise on a tp / pp / seq_parallel / attn_impl combination the trainer
    does not run (the JAX asserts, train/pretrain.py:54-97 there), and, with
    ``world`` (the processes), on a world the mesh cannot be laid on."""
    if cfg.pp > 1:
        # the JAX trainer's reasons (:59-72 there): SP and the ring shard the
        # residual stream's T inside the stage bodies; the layerwise backward
        # is another engine than the reverse pipeline
        if cfg.seq_parallel:
            raise ValueError("pp excludes seq_parallel")
        if cfg.attn_impl == "ring":
            raise ValueError("pp excludes ring attention")
        if cfg.layerwise_grad:
            raise ValueError("pp excludes layerwise_grad")
        if cfg.model.n_layer % cfg.pp:
            raise ValueError(f"n_layer {cfg.model.n_layer} is not divisible by pp={cfg.pp}")
        n_micro = cfg.pp_micro or cfg.pp
        if cfg.micro_batch_size % n_micro:
            raise ValueError(f"micro-batch {cfg.micro_batch_size} is not divisible by "
                             f"pp_micro={n_micro}")
        if world is not None and world % (cfg.pp * cfg.tp):
            raise ValueError(f"devices {world} not divisible by pp*tp={cfg.pp * cfg.tp}")
    if cfg.seq_parallel and cfg.tp <= 1:
        raise ValueError("seq_parallel requires tp > 1")
    if cfg.attn_impl == "ring":
        if cfg.tp <= 1:
            raise ValueError("attn_impl='ring' requires tp > 1 (the ring size)")
        if cfg.seq_len % cfg.tp:
            raise ValueError(f"attn_impl='ring': seq_len {cfg.seq_len} is not divisible "
                             f"by tp={cfg.tp}")
    if cfg.seq_parallel and cfg.seq_len % cfg.tp:
        raise ValueError(f"seq_parallel: seq_len {cfg.seq_len} is not divisible by "
                         f"tp={cfg.tp}")
    if cfg.seq_parallel and cfg.layerwise_grad:
        raise ValueError("layerwise_grad: no seq_parallel")


def run_pretrain(cfg: PretrainConfig, *, device, policy: Policy = DEFAULT_POLICY,
                 max_steps_override: Optional[int] = None, remat=False,
                 num_devices: Optional[int] = None) -> dict:
    """Run the pretrain loop on ``device`` (each rank's, parallel/mesh.
    device_for_rank). Returns {"model", "opt_state", "val_loss"}: this rank's
    model (its shards under tensor parallelism, its stage's layers under the
    pipeline). ``remat`` is models.gpt2.run_blocks' (False, True or a mode
    name). ``num_devices``: the world's size, checked when given."""
    device = init_distributed(device)
    world = world_size()
    check_parallel(cfg, world)
    ring = cfg.attn_impl == "ring"
    if world == 1 and cfg.tp > 1 and not ring:
        raise ValueError(
            f"tp={cfg.tp}: Megatron tensor parallelism runs over tp processes, one shard "
            "each (python -m torch.distributed.run --nproc_per_node N ...); this run is "
            "one process")
    if world > 1 and world % cfg.tp:
        raise ValueError(f"world {world} not divisible by tp={cfg.tp}")
    tp = cfg.tp if world > 1 else 1
    if cfg.pp > 1:  # JAX :74-87 there
        axes, shape = ("data", "pipe"), (world // (cfg.pp * tp), cfg.pp)
        if tp > 1:
            axes, shape = axes + ("model",), shape + (tp,)
        mesh = make_mesh(num_devices, axes, shape)
    else:
        mesh = make_mesh(num_devices, ("data", "model"), (world // tp, tp))
    # one process runs the ring's ranks in turn; over processes each
    # tensor-parallel attention runs the ring over the model group
    local_ring = ring and world == 1
    if local_ring:
        ring_attention.set_ring(cfg.tp)
    try:
        return _run_pretrain(cfg, device, policy, max_steps_override, remat, mesh)
    finally:
        if local_ring:
            ring_attention.set_ring(None)


def _run_pretrain(cfg, device, policy, max_steps_override, remat, mesh) -> dict:
    master = is_master()
    data_rank, data_world = mesh.coord("data"), mesh.size("data")
    n_model = mesh.size("model")
    accum = cfg.grad_accum_steps(data_world)
    if master:
        print(f"total desired batch size: {cfg.total_batch_size}")
        print(f"=> calculated gradient accumulation steps: {accum}")
        if mesh.world > 1:
            print(f"mesh: {mesh}")

    tokenizer = get_tokenizer()
    b, t = cfg.micro_batch_size, cfg.seq_len
    # the data ranks stride disjoint windows; the ranks of one model group
    # read the same rows
    train_loader = TokenShardLoader(b, t, rank=data_rank, world_size=data_world,
                                    split="train", data_dir=cfg.data_dir)
    val_loader = TokenShardLoader(b, t, rank=data_rank, world_size=data_world,
                                  split="val", data_dir=cfg.data_dir)

    # every rank builds the whole model from the seed, then keeps its shards
    model = gpt2.init(cfg.model, generator=torch.Generator(device).manual_seed(cfg.seed),
                      device=device)
    n_params = gpt2.param_count(model)
    placement, sync = setup_parallel(model, mesh, seq_parallel=cfg.seq_parallel)
    tp = placement.tp
    if cfg.param_dtype:
        # the whole-model cast, the reference's CUDA run (train_gpt2.py:264);
        # AdamW's arithmetic stays fp32 (train/optimizer.py)
        model.to(_DTYPES[cfg.param_dtype])
    opt_state = adamw_init(gpt2.named_params(model), state_dtype=cfg.opt_state_dtype,
                           placement=placement)
    params = gpt2.named_params(model)
    if master:
        part = [f"shards of {n_model}"] if tp is not None else []
        if placement.stage is not None:
            part.append(f"stage {placement.stage.index} of {placement.stage.count}")
        print(f"[init] parameters: {n_params:,}")
        print(f"[mem] params {fmt_count(gpt2.param_count(model))} in "
              f"{tree_bytes(params) / 2**30:.3f} GiB, moments "
              f"{tree_bytes([opt_state['m'], opt_state['v']]) / 2**30:.3f} GiB "
              f"({cfg.opt_state_dtype or 'param dtype'}), grad accumulators "
              f"{cfg.grad_accum_dtype or 'float32'}"
              + (f" (a rank's {', '.join(part)})" if part else ""))

    def loss_fn(model, micro):
        # micro: {"x", "y"}, (B, T) int32 each
        return gpt2.loss(model, micro["x"], cfg.model, targets=micro["y"],
                         policy=policy, attn_impl=cfg.attn_impl, remat=remat)

    layerwise_fn = None
    if cfg.layerwise_grad:
        def layerwise_fn(model, micro, acc):
            return gpt2.loss_grad_layerwise(model, micro["x"], cfg.model, targets=micro["y"],
                                            acc=acc, policy=policy, attn_impl=cfg.attn_impl)
    if placement.stage is not None:
        # the GPipe schedule over "pipe" (JAX :127-133 there): validation
        # through its forward, each step through the train step's
        # layerwise seam
        pipe = make_pipeline_loss_fn(cfg.model, mesh, n_micro=cfg.pp_micro or cfg.pp,
                                     policy=policy, attn_impl=cfg.attn_impl, remat=remat)
        loss_fn, layerwise_fn = pipe.loss, pipe.loss_grad

    train_step = make_train_step(
        loss_fn, cfg.optimizer, cfg.schedule, decay_mask=gpt2.decay_mask(model),
        nan_guard=cfg.nan_guard, grad_accum_dtype=cfg.grad_accum_dtype,
        layerwise_loss_grad=layerwise_fn, grad_sync=sync, placement=placement,
    )
    eval_step = make_eval_step(loss_fn)

    def whole_tree(model, opt_state):
        """The checkpoint's tree: whole tensors and whole 8-bit buffers (every
        rank's part gathered), as one process writes them."""
        sd, m, v = (placement.whole(x) for x in (model.state_dict(), opt_state["m"],
                                                  opt_state["v"]))
        return {"model": sd, "opt_state": {"m": m, "v": v, "step": opt_state["step"]}}

    @contextlib.contextmanager
    def whole_model():
        """The model with every layer, for HellaSwag and sampling: under the
        pipeline the stages gathered (the cost printed by the master)."""
        stats = {}
        with whole_stages(model, stats) as whole:
            if master and stats:
                print(f"[pp] stages gathered for the event: {stats['bytes'] / 2**20:.1f} MiB "
                      f"in {stats['seconds']:.3f} s")
            yield whole

    log = MetricsLogger(cfg.log_dir, is_master=master)
    log.meta("tokenizer", tokenizer.name)
    log.meta("argv", " ".join(sys.argv))
    prof = ProfilerHook()
    manager = CheckpointManager(os.path.join(log.log_dir, "ckpts"),
                                save_every=cfg.save_every, enabled=cfg.save_ckpt,
                                is_master=master, tree_fn=whole_tree)
    hella = HellaSwagEvaluator(cfg.model, policy=policy)
    hellaswag_dir_ok = os.path.isdir(os.environ.get("HELLASWAG_DIR", "hellaswag"))
    decoder = Decoder(cfg.model, policy=policy, sample_fn=sample_top_k)

    start_step = 0
    resumed = manager.maybe_resume(map_location=device)
    if resumed is not None:
        tree, meta = resumed
        sd, saved = tree["model"], tree["opt_state"]
        # the configured moment storage, whatever the checkpoint's, converted
        # on the whole trees at the configured param dtype; then this rank's
        # part of each
        pdt = next(iter(params.values())).dtype
        saved = convert_moments({n: sd[n].to(pdt) for n in placement.whole_names()}, saved,
                                cfg.opt_state_dtype)
        opt_state = {**saved, "m": placement.local(saved["m"]), "v": placement.local(saved["v"]),
                     "step": int(saved["step"])}
        # load_state_dict copies into the params as they are, so a checkpoint
        # of another dtype comes in at the configured param_dtype
        model.load_state_dict(placement.local(sd))
        start_step = int(meta["next_step"])
        # the data stream goes on where the uninterrupted run would be
        train_loader.seek(start_step * accum)
        if master:
            print(f"[ckpt] resumed at step {start_step}")

    max_steps = max_steps_override or cfg.schedule.max_steps
    val_loss = float("nan")
    tokens_per_step = b * t * accum * data_world
    final_step, halted = start_step - 1, False
    # after the resume's seek: the thread reads on from where this run starts
    prefetch = HostPrefetcher(lambda: train_loader.next_accum_rowbuf(accum),
                              stage=lambda rows: upload_rows(rows, device))
    try:
        for step in range(start_step, max_steps):
            t0 = time.time()
            last_step = step == max_steps - 1
            if cfg.val_every and (step % cfg.val_every == 0 or last_step):
                val_loader.reset()
                vrows = upload_rows(val_loader.next_accum_rowbuf(cfg.val_steps), device)
                vbatch = split_rows_on_device(vrows)
                vl = eval_step(model, vbatch)
                val_loss = float(vl if sync is None else sync.mean_loss(vl))
                log.val(step, val_loss)
                manager.save_step(step, model, opt_state, val_loss, last_step=last_step)

            if (cfg.run_hellaswag and hellaswag_dir_ok
                    and cfg.hellaswag_every  # 0 disables, like val/sample_every
                    and (step % cfg.hellaswag_every == 0 or last_step)):
                # examples round-robin over the data ranks, counts summed
                # (train_gpt2.py:399,410-416)
                with whole_model() as whole:
                    correct, total = hella.evaluate(whole, tokenizer, rank=data_rank,
                                                    world_size=data_world)
                if data_world > 1:
                    counts = torch.tensor([correct, total], dtype=torch.float32, device=device)
                    coll.all_reduce_(counts, mesh.group("data"))
                    correct, total = (int(c) for c in counts.tolist())
                if total:
                    log.hellaswag(step, correct / total, correct, total)

            if cfg.sample_every and ((step > 0 and step % cfg.sample_every == 0) or last_step):
                prompt = tokenizer.encode("Hello, I'm a language model,")
                ids = torch.tensor([prompt] * 4, device=device)
                # seed 42 + data rank, re-seeded at each sampling event
                # (train_gpt2.py:438-439): the ranks of one model group draw
                # the same tokens, as their collectives need
                gen = torch.Generator(device).manual_seed(42 + data_rank)
                with whole_model() as whole:
                    toks, _ = decoder.generate(whole, ids, max(1, 32 - len(prompt)), gen)
                if master:
                    for i in range(4):
                        print(f"sample {i}: {tokenizer.decode(prompt + toks[i].tolist())}")

            batch = split_rows_on_device(prefetch.next())
            metrics = train_step(model, opt_state, batch, step)
            final_step = step
            if not (math.isfinite(metrics["loss"]) and math.isfinite(metrics["grad_norm"])):
                # the step skipped its update; stop with usable checkpoints on disk
                print(f"[guard] non-finite loss/grad at step {step}; halting")
                halted = True
                break
            dt = time.time() - t0
            log.train(step, metrics["loss"], metrics["lr"], metrics["grad_norm"],
                      dt * 1000, tokens_per_step / dt)
            prof.step(step)
    finally:
        prefetch.close()

    next_step = final_step if halted else final_step + 1
    manager.save_final(final_step, model, opt_state, val_loss, next_step=next_step)
    if master:
        log.export_xlsx()
    return {"model": model, "opt_state": opt_state, "val_loss": val_loss}
