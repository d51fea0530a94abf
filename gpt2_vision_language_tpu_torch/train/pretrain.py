"""FineWeb-Edu GPT-2 pretraining workload on one device.

Counterpart of gpt2_vision_language_tpu/train/pretrain.py:44-466 for a
single device: the reference's cadences (val every 250, samples every 250,
rolling checkpoint every 2500, auto-resume), its CSV schema and its
hyperparameters through ``PretrainConfig``. The token shards are read by
``data/fineweb.TokenShardLoader`` and the CSV is written by
``obs/csvlog.MetricsLogger``, the port's own copies of the JAX package's host
modules. Each step's (accum, B, T+1) row buffer goes to the device as one
pinned int32 tensor. HellaSwag runs every ``hellaswag_every`` steps and at
the last step when ``run_hellaswag`` is set and ``$HELLASWAG_DIR`` (default
``./hellaswag``) is a directory.
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
from ..data.tokenizer import get_tokenizer
from ..eval.hellaswag import HellaSwagEvaluator
from ..infer.decode import Decoder
from ..infer.sampling import sample_top_k
from ..models import gpt2
from ..obs.csvlog import MetricsLogger
from .optimizer import adamw_init
from .step import make_eval_step, make_train_step


def stage_rows(rows: np.ndarray, device: torch.device) -> torch.Tensor:
    """(..., B, T+1) token rows -> one int32 tensor on ``device`` (through
    pinned memory for a CUDA device)."""
    t = torch.from_numpy(rows.astype(np.int32))
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def run_pretrain(cfg: PretrainConfig, *, device, policy: Policy = DEFAULT_POLICY,
                 max_steps_override: Optional[int] = None) -> dict:
    """Run the pretrain loop on ``device``. Returns {"model", "opt_state",
    "val_loss"}."""
    device = torch.device(device)
    accum = cfg.grad_accum_steps(1)
    print(f"total desired batch size: {cfg.total_batch_size}")
    print(f"=> calculated gradient accumulation steps: {accum}")

    tokenizer = get_tokenizer()
    b, t = cfg.micro_batch_size, cfg.seq_len
    train_loader = TokenShardLoader(b, t, split="train", data_dir=cfg.data_dir)
    val_loader = TokenShardLoader(b, t, split="val", data_dir=cfg.data_dir)

    model = gpt2.init(cfg.model, generator=torch.Generator(device).manual_seed(cfg.seed),
                      device=device)
    opt_state = adamw_init(gpt2.named_params(model))
    print(f"[init] parameters: {gpt2.param_count(model):,}")

    def loss_fn(model, micro):
        # micro: (B, T+1) rows; x = rows[:, :-1], y = rows[:, 1:]
        return gpt2.loss(model, micro[:, :-1], cfg.model, targets=micro[:, 1:],
                         policy=policy, attn_impl=cfg.attn_impl)

    train_step = make_train_step(
        loss_fn, cfg.optimizer, cfg.schedule, decay_mask=gpt2.decay_mask(model),
        nan_guard=cfg.nan_guard,
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
        model.load_state_dict(tree["model"])
        saved = tree["opt_state"]
        with torch.no_grad():
            for key in ("m", "v"):
                for n, a in opt_state[key].items():
                    a.copy_(saved[key][n])
        opt_state["step"] = int(saved["step"])
        start_step = int(meta["next_step"])
        # the data stream goes on where the uninterrupted run would be
        train_loader.seek(start_step * accum)
        print(f"[ckpt] resumed at step {start_step}")

    max_steps = max_steps_override or cfg.schedule.max_steps
    val_loss = float("nan")
    tokens_per_step = b * t * accum
    final_step, halted = start_step - 1, False
    for step in range(start_step, max_steps):
        t0 = time.time()
        last_step = step == max_steps - 1
        if cfg.val_every and (step % cfg.val_every == 0 or last_step):
            val_loader.reset()
            vbatch = stage_rows(val_loader.next_accum_rowbuf(cfg.val_steps), device)
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

        batch = stage_rows(train_loader.next_accum_rowbuf(accum), device)
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

    next_step = final_step if halted else final_step + 1
    manager.save_final(final_step, model, opt_state, val_loss, next_step=next_step)
    log.export_xlsx()
    return {"model": model, "opt_state": opt_state, "val_loss": val_loss}
