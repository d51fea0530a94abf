"""Metrics logging with the reference-compatible CSV schema.

Schema and artifacts match train_gpt2.py:289-305,484-492,509-517 so existing
analysis notebooks keep working: `train_{ts}.csv` with columns
[time, phase, step, loss, lr, grad_norm, dt_ms, tok_per_s, hellaswag_acc],
phases train/val/hella/cider; `log.txt`; end-of-run XLSX export. The
port's own copy of gpt2_vision_language_tpu/obs/csvlog.py MetricsLogger
(stdlib only; the same rows from the same calls), and its ProfilerHook on
torch.profiler (torch imported when a trace starts), which carries the
port's spans into its trace."""

from __future__ import annotations

import csv
import os
import time
from typing import Optional

from . import spans


class MetricsLogger:
    SCHEMA = [
        "time",
        "phase",
        "step",
        "loss",
        "lr",
        "grad_norm",
        "dt_ms",
        "tok_per_s",
        "hellaswag_acc",
    ]

    def __init__(self, log_dir: Optional[str] = None, *, is_master: bool = True):
        self.is_master = is_master
        self.log_dir = log_dir or os.environ.get("LOG_DIR", "log")
        self.ts = time.strftime("%Y%m%d_%H%M%S")
        self.csv_path = os.path.join(self.log_dir, f"train_{self.ts}.csv")
        self.txt_path = os.path.join(self.log_dir, "log.txt")
        if not is_master:
            return
        os.makedirs(self.log_dir, exist_ok=True)
        if not os.path.exists(self.txt_path):
            open(self.txt_path, "w").close()
        if not os.path.exists(self.csv_path):
            with open(self.csv_path, "w", newline="") as f:
                csv.writer(f).writerow(self.SCHEMA)

    def _row(self, phase, step, **kw):
        if not self.is_master:
            return
        row = [
            time.strftime("%Y-%m-%d %H:%M:%S"),
            phase,
            step,
            kw.get("loss", ""),
            kw.get("lr", ""),
            kw.get("grad_norm", ""),
            kw.get("dt_ms", ""),
            kw.get("tok_per_s", ""),
            kw.get("hellaswag_acc", ""),
        ]
        with open(self.csv_path, "a", newline="") as f:
            csv.writer(f).writerow(row)

    def meta(self, key: str, value: str):
        """Provenance stamp (phase='meta', `key=value` in the loss column):
        records run-environment facts a future reader of the artifact needs
        to interpret the numbers — most importantly which tokenizer
        produced the run (a byte-fallback-vocab run's losses/samples are
        not comparable to real-BPE runs; VERDICT r2 weak #4). Analysis
        that filters on phase in {train,val,hella,cider} is unaffected."""
        if self.is_master:
            with open(self.txt_path, "a") as f:
                f.write(f"meta {key}={value}\n")
        self._row("meta", 0, loss=f"{key}={value}")

    def train(self, step, loss, lr, grad_norm, dt_ms, tok_per_s, eta_sec=None):
        if self.is_master:
            eta = ""
            if eta_sec is not None:
                h, rem = divmod(int(eta_sec), 3600)
                m, sec = divmod(rem, 60)
                eta = f" | ETA: {h:02d}h{m:02d}m{sec:02d}s"
            print(
                f"step {step:5d} | loss: {loss:.6f} | lr {lr:.4e} | "
                f"norm: {grad_norm:.4f} | dt: {dt_ms:.2f}ms | "
                f"tok/sec: {tok_per_s:.2f}" + eta
            )
        self._row(
            "train",
            step,
            loss=f"{loss:.6f}",
            lr=f"{lr:.6e}",
            grad_norm=f"{grad_norm:.4f}",
            dt_ms=f"{dt_ms:.2f}",
            tok_per_s=f"{tok_per_s:.2f}",
        )

    def val(self, step, loss):
        if self.is_master:
            print(f"validation loss: {loss:.4f}")
        self._row("val", step, loss=f"{loss:.6f}")

    def hellaswag(self, step, acc, correct=None, total=None):
        if self.is_master:
            if correct is not None:
                print(f"HellaSwag accuracy: {correct}/{total}={acc:.4f}")
            with open(self.txt_path, "a") as f:
                f.write(f"{step} hella {acc:.4f}\n")
        self._row("hella", step, hellaswag_acc=f"{acc:.4f}")

    def cider(self, step, score):
        if self.is_master:
            print(f"[CIDEr] step {step}: {score:.4f}")
        self._row("cider", step, hellaswag_acc=f"{score:.6f}")

    def export_xlsx(self):
        """CSV->XLSX export (train_gpt2.py:509-517), via our stdlib-only
        writer (openpyxl is not a dependency). Non-fatal on error."""
        if not self.is_master:
            return
        try:
            from .xlsx import csv_to_xlsx

            xlsx = self.csv_path.replace(".csv", ".xlsx")
            csv_to_xlsx(self.csv_path, xlsx)
            print(f"[excel] written: {xlsx}")
        except Exception as e:  # noqa: BLE001 — parity: failure is non-fatal
            print(f"failed to convert to xlsx: {e}")


class ProfilerHook:
    """torch.profiler trace around a step window: set PROFILE_DIR to enable.

    The JAX hook's names and window: the trainer calls ``step(step)`` after
    each step's log line; at ``start_step`` it starts a trace and at
    ``start_step + num_steps`` it stops it, so the trace holds steps
    start_step + 1 .. start_step + num_steps and whatever the trainer ran
    between those calls. It records the CPU, and the card's kernels where
    CUDA is available, and writes one Chrome trace under PROFILE_DIR when
    the window closes (``<host>_<pid>.<ms>.pt.trace.json``, torch's
    ``tensorboard_trace_handler``). The port's own spans (``obs/spans.py``)
    are on inside the window and are appended to that trace on its clock
    (``cat: "gpt2vl"``), so the train step's phases, the linears, the
    attention, the CE and the optimizer lie beside the kernels in one file.
    PROFILE_DIR unset or empty means off. As in the JAX hook, a run that ends
    inside the window never stops its trace: nothing is written, and the
    profiler (and the spans) stay on in that process, so a later window
    there fails to start."""

    def __init__(self, start_step: int = 10, num_steps: int = 5):
        self.dir = os.environ.get("PROFILE_DIR")
        self.start = start_step
        self.stop = start_step + num_steps
        self._prof = None  # the running trace

    def step(self, step: int):
        if not self.dir:
            return
        import torch

        if step == self.start and self._prof is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities,
                                                on_trace_ready=self._write)
            spans.enable()
            self._prof.start()
        elif step == self.stop and self._prof is not None:
            self._prof.stop()
            self._prof = None

    def _write(self, prof):
        """torch's handler writes the trace; the window's spans go into it."""
        import torch

        before = set(os.listdir(self.dir)) if os.path.isdir(self.dir) else set()
        torch.profiler.tensorboard_trace_handler(self.dir)(prof)
        records = spans.drain()
        spans.disable()
        for name in sorted(set(os.listdir(self.dir)) - before):
            if name.endswith(".json"):
                spans.write_into(os.path.join(self.dir, name), records)
