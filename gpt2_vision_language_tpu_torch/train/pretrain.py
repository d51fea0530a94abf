"""FineWeb-Edu GPT-2 pretraining workload on one device.

Counterpart of gpt2_vision_language_tpu/train/pretrain.py:44-466 for a
single device: the reference's cadences (val every 250, samples every 250,
rolling checkpoint every 2500, auto-resume), its CSV schema and its
hyperparameters through ``PretrainConfig``. The token shards are read by
``data/fineweb.TokenShardLoader`` and the CSV is written by
``obs/csvlog.MetricsLogger``, the port's own copies of the JAX package's host
modules. Each step's (accum, B, T+1) uint16 row buffer is read and copied to
the device by a background thread (``data/pipeline.HostPrefetcher``: the next
window is on its way while the current step runs), in its 16 bits through
pinned memory, and split into x, y and widened to int32 there, as the JAX
trainer does (``split_rows_on_device``). HellaSwag runs every
``hellaswag_every`` steps and at the last step when ``run_hellaswag`` is set
and ``$HELLASWAG_DIR`` (default ``./hellaswag``) is a directory. ``attn_impl="ring"`` (:88-96, :134-138,
:462-465 there) needs ``tp > 1`` chunks that divide ``seq_len``; the ring is
run in turn by this one process (``ops.ring_attention.LocalRing``), installed
before the first step and removed when the run ends. ``tp > 1`` with any
other ``attn_impl`` would be Megatron tensor parallelism, which is not ported.

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
from ..obs.csvlog import MetricsLogger
from ..ops import ring_attention
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
    gpt2_vision_language_tpu/data/fineweb.py split_rows_on_device)."""
    wide = rows.to(torch.int32) & 0xFFFF
    return {"x": wide[..., :-1], "y": wide[..., 1:]}


def check_parallel(cfg: PretrainConfig) -> None:
    """Raise on a tp / attn_impl combination the single-device trainer does
    not run."""
    if cfg.attn_impl == "ring":
        if cfg.tp <= 1:
            raise ValueError("attn_impl='ring' requires tp > 1 (the ring size)")
        if cfg.seq_len % cfg.tp:
            raise ValueError(f"attn_impl='ring': seq_len {cfg.seq_len} is not divisible "
                             f"by tp={cfg.tp}")
    elif cfg.tp != 1:
        raise NotImplementedError(
            f"tp={cfg.tp} without attn_impl='ring' is Megatron tensor parallelism, which "
            "is not ported yet (ROADMAP Queue 1 item 10)"
        )


def run_pretrain(cfg: PretrainConfig, *, device, policy: Policy = DEFAULT_POLICY,
                 max_steps_override: Optional[int] = None, remat=False) -> dict:
    """Run the pretrain loop on ``device``. Returns {"model", "opt_state",
    "val_loss"}. ``remat`` is models.gpt2.run_blocks' (False, True or a mode
    name)."""
    check_parallel(cfg)
    ring = cfg.attn_impl == "ring"
    if ring:
        ring_attention.set_ring(cfg.tp)
    try:
        return _run_pretrain(cfg, torch.device(device), policy, max_steps_override, remat)
    finally:
        if ring:
            ring_attention.set_ring(None)


def _run_pretrain(cfg, device, policy, max_steps_override, remat) -> dict:
    accum = cfg.grad_accum_steps(1)
    print(f"total desired batch size: {cfg.total_batch_size}")
    print(f"=> calculated gradient accumulation steps: {accum}")

    tokenizer = get_tokenizer()
    b, t = cfg.micro_batch_size, cfg.seq_len
    train_loader = TokenShardLoader(b, t, split="train", data_dir=cfg.data_dir)
    val_loader = TokenShardLoader(b, t, split="val", data_dir=cfg.data_dir)

    model = gpt2.init(cfg.model, generator=torch.Generator(device).manual_seed(cfg.seed),
                      device=device)
    if cfg.param_dtype:
        # the whole-model cast, the reference's CUDA run (train_gpt2.py:264);
        # AdamW's arithmetic stays fp32 (train/optimizer.py)
        model.to(_DTYPES[cfg.param_dtype])
    opt_state = adamw_init(gpt2.named_params(model), state_dtype=cfg.opt_state_dtype)
    params = gpt2.named_params(model)
    print(f"[init] parameters: {gpt2.param_count(model):,}")
    print(f"[mem] params {fmt_count(gpt2.param_count(model))} in "
          f"{tree_bytes(params) / 2**30:.3f} GiB, moments "
          f"{tree_bytes([opt_state['m'], opt_state['v']]) / 2**30:.3f} GiB "
          f"({cfg.opt_state_dtype or 'param dtype'}), grad accumulators "
          f"{cfg.grad_accum_dtype or 'float32'}")

    def loss_fn(model, micro):
        # micro: {"x", "y"}, (B, T) int32 each
        return gpt2.loss(model, micro["x"], cfg.model, targets=micro["y"],
                         policy=policy, attn_impl=cfg.attn_impl, remat=remat)

    layerwise_fn = None
    if cfg.layerwise_grad:
        def layerwise_fn(model, micro, acc):
            return gpt2.loss_grad_layerwise(model, micro["x"], cfg.model, targets=micro["y"],
                                            acc=acc, policy=policy, attn_impl=cfg.attn_impl)

    train_step = make_train_step(
        loss_fn, cfg.optimizer, cfg.schedule, decay_mask=gpt2.decay_mask(model),
        nan_guard=cfg.nan_guard, grad_accum_dtype=cfg.grad_accum_dtype,
        layerwise_loss_grad=layerwise_fn,
    )
    eval_step = make_eval_step(loss_fn)

    log = MetricsLogger(cfg.log_dir)
    log.meta("tokenizer", tokenizer.name)
    log.meta("argv", " ".join(sys.argv))
    manager = CheckpointManager(os.path.join(log.log_dir, "ckpts"),
                                save_every=cfg.save_every, enabled=cfg.save_ckpt)
    hella = HellaSwagEvaluator(cfg.model, policy=policy)
    hellaswag_dir_ok = os.path.isdir(os.environ.get("HELLASWAG_DIR", "hellaswag"))
    decoder = Decoder(cfg.model, policy=policy, sample_fn=sample_top_k)

    start_step = 0
    resumed = manager.maybe_resume(map_location=device)
    if resumed is not None:
        tree, meta = resumed
        # load_state_dict copies into the params as they are, so a checkpoint
        # of another dtype comes in at the configured param_dtype
        model.load_state_dict(tree["model"])
        # the configured moment storage, whatever the checkpoint's
        opt_state = convert_moments(params, tree["opt_state"], cfg.opt_state_dtype)
        opt_state["step"] = int(opt_state["step"])
        start_step = int(meta["next_step"])
        # the data stream goes on where the uninterrupted run would be
        train_loader.seek(start_step * accum)
        print(f"[ckpt] resumed at step {start_step}")

    max_steps = max_steps_override or cfg.schedule.max_steps
    val_loss = float("nan")
    tokens_per_step = b * t * accum
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
                val_loss = float(eval_step(model, vbatch))
                log.val(step, val_loss)
                manager.save_step(step, model, opt_state, val_loss, last_step=last_step)

            if (cfg.run_hellaswag and hellaswag_dir_ok
                    and cfg.hellaswag_every  # 0 disables, like val/sample_every
                    and (step % cfg.hellaswag_every == 0 or last_step)):
                correct, total = hella.evaluate(model, tokenizer)
                if total:
                    log.hellaswag(step, correct / total, correct, total)

            if cfg.sample_every and ((step > 0 and step % cfg.sample_every == 0) or last_step):
                prompt = tokenizer.encode("Hello, I'm a language model,")
                ids = torch.tensor([prompt] * 4, device=device)
                # seed 42, re-seeded at each sampling event (train_gpt2.py:438-439)
                toks, _ = decoder.generate(model, ids, max(1, 32 - len(prompt)),
                                           torch.Generator(device).manual_seed(42))
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
    finally:
        prefetch.close()

    next_step = final_step if halted else final_step + 1
    manager.save_final(final_step, model, opt_state, val_loss, next_step=next_step)
    log.export_xlsx()
    return {"model": model, "opt_state": opt_state, "val_loss": val_loss}
