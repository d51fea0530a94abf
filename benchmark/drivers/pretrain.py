"""Driver of the pretraining cells: one device's step as the trainer composes it.

``Trainer`` rebuilds ``train/pretrain._run_pretrain``'s composition from the
program's public functions, with the arguments ``PretrainConfig`` gives:
seeded Zipf shards (``benchmark/harness/traffic.py``) read by
``data/fineweb.TokenShardLoader``, a ``data/pipeline.HostPrefetcher`` that
reads each step's (accum, B, T + 1) rows and uploads them
(``train/pretrain.upload_rows``), ``train/pretrain.split_rows_on_device``,
and ``train/step.make_train_step`` over ``models/gpt2.loss`` under the
traffic's policy, with AdamW's moments from ``train/optimizer.adamw_init``.
Validation, HellaSwag, sampling and checkpoints are off: their cadences lie
far past a window. The weights are the benchmark's own (``harness/weights``),
copied into the program's model.

``run`` is one run of a cell. Set-up builds the trainer and drives its first
steps (the traffic's ``checked_steps``) through the window's own call and feed; their losses, the
first gradient as AdamW got it (from the first moment) and each parameter's
change are kept. Then the window runs whole steps until ``seconds`` have
passed, and with ``trace`` the profiled steps follow. Once the program's
state is freed, the plain reference (``benchmark/reference/gpt2.py``) runs the
checked steps again from the same weights on the same rows.

The program is reached through its modules' attributes at call time, so that
a check can plant a fault in it (``benchmark/faults.py``).
"""

from __future__ import annotations

import contextlib
import gc
import math
import os
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import torch

from gpt2_vision_language_tpu_torch.core import config as port_config
from gpt2_vision_language_tpu_torch.core import precision as port_precision
from gpt2_vision_language_tpu_torch.data import fineweb as port_fineweb
from gpt2_vision_language_tpu_torch.data import pipeline as port_pipeline
from gpt2_vision_language_tpu_torch.models import gpt2 as port_gpt2
from gpt2_vision_language_tpu_torch.train import optimizer as port_optimizer
from gpt2_vision_language_tpu_torch.train import pretrain as port_pretrain
from gpt2_vision_language_tpu_torch.train import step as port_step

from harness import compare as cmp
from harness import trace as tr
from harness import traffic as gen
from harness import weights as seeded
from reference import gpt2 as reference

POLICIES = {"bf16": "DEFAULT_POLICY", "fp32": "FP32_POLICY"}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Trainer:
    """One device's pretraining step as ``_run_pretrain`` composes it, fed by
    its own prefetching loader over the shards in ``data_dir``."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, data_dir: str,
                 init: dict):
        b, t, accum = traffic["micro_batch_size"], traffic["seq_len"], traffic["grad_accum_steps"]
        self.dims = seeded.dims(config, t)
        d = self.dims
        gcfg = port_config.GPTConfig(block_size=d["block"], vocab_size=d["vocab"],
                                     n_layer=d["n_layer"], n_head=d["n_head"],
                                     n_embd=d["n_embd"], unroll_layers=True)
        if gcfg.padded_vocab_size != d["vocab_pad"]:
            raise ValueError(f"the program pads the vocabulary to {gcfg.padded_vocab_size}, "
                             f"the configuration to {d['vocab_pad']}")
        self.pcfg = port_config.PretrainConfig(
            model=gcfg, total_batch_size=b * t * accum, micro_batch_size=b, seq_len=t,
            schedule=port_config.ScheduleConfig(**traffic["schedule"]),
            optimizer=port_config.OptimizerConfig(**traffic["optimizer"]),
            val_every=0, hellaswag_every=0, sample_every=0, run_hellaswag=False,
            save_ckpt=False, seed=seed, data_dir=data_dir)
        pcfg = self.pcfg
        self.accum = pcfg.grad_accum_steps(1)
        self.tokens_per_step = b * t * self.accum
        policy = getattr(port_precision, POLICIES[traffic["policy"]])
        remat = bool(traffic["remat"])
        self.device = torch.device(device)
        with torch.device(self.device):
            self.model = port_gpt2.GPT2(gcfg)
        params = port_gpt2.named_params(self.model)
        got = {n: tuple(p.shape) for n, p in params.items()}
        want = {n: tuple(w.shape) for n, w in init.items()}
        if got != want:
            raise ValueError("the program's parameters are not the configuration's: "
                             f"{sorted(set(got.items()) ^ set(want.items()))[:4]}")
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(init[n])
        self.opt_state = port_optimizer.adamw_init(params, state_dtype=pcfg.opt_state_dtype)
        self.spans = False

        def loss_fn(model, micro):  # train/pretrain.py _run_pretrain's
            with self._span("bench.forward"):
                return port_gpt2.loss(model, micro["x"], pcfg.model, targets=micro["y"],
                                      policy=policy, attn_impl=pcfg.attn_impl, remat=remat)

        self.train_step = port_step.make_train_step(
            loss_fn, pcfg.optimizer, pcfg.schedule, decay_mask=port_gpt2.decay_mask(self.model),
            nan_guard=pcfg.nan_guard, grad_accum_dtype=pcfg.grad_accum_dtype)
        loader = port_fineweb.TokenShardLoader(b, t, split="train", data_dir=data_dir)
        accum_ = self.accum
        self.prefetch = port_pipeline.HostPrefetcher(
            lambda: loader.next_accum_rowbuf(accum_),
            stage=lambda rows: port_pretrain.upload_rows(rows, self.device))

    def _span(self, name):
        if not self.spans:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def step(self, idx: int):
        """One step of the trainer's loop: (metrics, seconds waited for the
        prefetcher)."""
        t0 = time.perf_counter()
        with self._span("bench.prefetch_wait"):
            rows = self.prefetch.next()
        wait = time.perf_counter() - t0
        with self._span("bench.split_rows"):
            batch = port_pretrain.split_rows_on_device(rows)
        with self._span("bench.train_step"):
            metrics = self.train_step(self.model, self.opt_state, batch, idx)
        return metrics, wait

    def first_moment_norms(self) -> dict:
        """name -> the norm of the first moment over (1 - beta1): after one
        step from zero moments, the norm of the gradient AdamW got."""
        beta1 = self.pcfg.optimizer.beta1
        names = list(port_gpt2.named_params(self.model))
        ms = [self.opt_state["m"][n] for n in names]
        if any(not isinstance(m, torch.Tensor) or m.shape != p.shape
               for m, p in zip(ms, port_gpt2.named_params(self.model).values())):
            raise ValueError("the first moments are not held a tensor a parameter")
        vals = torch.stack([m.detach().double().norm() for m in ms]).tolist()
        return {n: v / (1.0 - beta1) for n, v in zip(names, vals)}

    def change(self, init: dict) -> dict:
        """name -> the parameter's change since ``init``, on the host."""
        with torch.no_grad():
            return {n: (p.detach() - init[n]).cpu()
                    for n, p in port_gpt2.named_params(self.model).items()}

    def close(self):
        self.prefetch.close()


def masked_norms(change: dict, kept: dict) -> dict:
    """name -> the norm of the host tensor change[name] over the elements
    that kept[name] (on the device) holds."""
    names = list(change)
    vals = [change[n].to(kept[n].device)[kept[n]].double().norm() for n in names]
    return dict(zip(names, torch.stack(vals).tolist()))


def finite(metrics) -> bool:
    return math.isfinite(metrics["loss"]) and math.isfinite(metrics["grad_norm"])


def card(device) -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    if torch.device(device).type != "cuda":
        return "no card"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def run(ctx) -> SimpleNamespace:
    """One run of a pretraining cell. ``ctx``: config, traffic (dicts),
    seed, seconds, trace, device, t_start (perf_counter at the process's
    start). Returns the run's record: what the metric readers and the
    comparison take."""
    config, traffic, device = ctx.config, ctx.traffic, torch.device(ctx.device)
    t, b, accum = traffic["seq_len"], traffic["micro_batch_size"], traffic["grad_accum_steps"]
    checked = int(traffic["checked_steps"])
    rec = SimpleNamespace(config=config, traffic=traffic, dims=seeded.dims(config, t),
                          compute=traffic["policy"], trace=None, failed=0)
    with tempfile.TemporaryDirectory(prefix="gpt2-bench-") as tmp:
        paths = gen.write_shards(os.path.join(tmp, "shards"), traffic["tokens"], ctx.seed)
        flat, init = seeded.make(config, t, ctx.seed, device)
        trainer = Trainer(config, traffic, ctx.seed, device, os.path.dirname(paths[0]), init)
        try:
            losses, grad = [], None
            for s in range(checked):
                m, _ = trainer.step(s)
                losses.append(m["loss"])
                rec.failed += not finite(m)
                if s == 0:
                    grad = trainer.first_moment_norms()
            change = trainer.change(init)
            rec.program = {"loss": losses, "grad": grad}
            del flat, init
            gc.collect()
            sync(device)
            rec.setup_s = time.perf_counter() - ctx.t_start

            # the window: whole steps from a step boundary until `seconds` have passed
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            idx, waits, step_s = checked, [], []
            sync(device)
            t0 = time.perf_counter()
            while True:
                ts = time.perf_counter()
                m, wait = trainer.step(idx)
                idx += 1
                waits.append(wait)
                step_s.append(time.perf_counter() - ts)
                rec.failed += not finite(m)
                if time.perf_counter() - t0 >= ctx.seconds:
                    break
            sync(device)
            seconds = time.perf_counter() - t0
            rec.memory_peak_bytes = (torch.cuda.max_memory_allocated(device)
                                     if device.type == "cuda" else 0)
            rec.window = {"steps": len(waits), "tokens": len(waits) * trainer.tokens_per_step,
                          "seconds": seconds, "tokens_per_step": trainer.tokens_per_step,
                          "step_s": step_s, "prefetch_wait_s": waits}
            rec.attempted = idx
            log(f"[window] {len(waits)} steps of {trainer.tokens_per_step} tokens in "
                f"{seconds:.4f} s; host step s min {min(step_s):.4f} max {max(step_s):.4f}; "
                f"peak {rec.memory_peak_bytes} B; set-up {rec.setup_s:.3f} s")
            log("[window] host step s " + " ".join(f"{x:.4f}" for x in step_s))

            if ctx.trace:
                n = int(traffic["trace_steps"])

                def counted(i):
                    m, _ = trainer.step(i)
                    rec.failed += not finite(m)

                rec.trace = tr.profile_device(lambda: [counted(idx + i) for i in range(n)], n,
                                              os.path.join(tmp, "device.json"))
                log(f"[trace] {n} steps on the device alone in {rec.trace['window_us'] * 1e-6:.4f}"
                    f" s (unprofiled {seconds / len(waits) * n:.4f} s)")
                trainer.spans = True
                rec.trace["gaps"] = tr.profile_host(lambda: counted(idx + n),
                                                    os.path.join(tmp, "host.json"))
                trainer.spans = False
                rec.trace["mm_ops"] = tr.profile_shapes(lambda: counted(idx + n + 1))
                rec.attempted = idx + n + 2
        finally:
            trainer.close()
        rec.card = card(device)
        log(f"[card] {rec.card}")
        del trainer
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

        # the plain reference, from the same weights on the same rows
        t_ref = time.perf_counter()
        flat, init = seeded.make(config, t, ctx.seed, device)
        rows = gen.step_rows(paths, b, t, accum, checked)
        rec.reference = reference.train_steps(
            init, rows, rec.dims, traffic["optimizer"], traffic["schedule"],
            precision="fp32", block_tokens=int(traffic["reference_block_tokens"]))
        del flat, init
        # the program's change over the elements the reference holds to it
        rec.program["change"] = masked_norms(change, rec.reference.pop("kept"))
        sync(device)
        rec.reference_s = time.perf_counter() - t_ref
        log(f"[reference] {rec.reference_s:.3f} s; losses program {rec.program['loss']} "
            f"reference {rec.reference['loss']}")
    return rec


def compare(rec) -> dict:
    """The numbers that decide ``correct`` (``harness/compare.readings``)."""
    numbers = cmp.readings(rec.program, rec.reference)
    log(f"[compare] worst grad leaf {numbers['worst_grad_leaf']}, worst update leaf "
        f"{numbers['worst_update_leaf']}, elements left out of the update {numbers['left_out']}")
    return numbers
