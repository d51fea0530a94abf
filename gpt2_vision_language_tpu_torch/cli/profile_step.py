"""CLI: profile one GPT-2 train step on the CUDA device, by kernel.

    python -m gpt2_vision_language_tpu_torch.cli.profile_step \
        [--seq-len 16384] [--micro-batch 1] [--accum 2] [--n-layer 12]

Builds GPT-2 124M with seeded random weights (``block_size`` grown to
``--seq-len``), runs ``train.step.make_train_step`` on a seeded random batch
(bf16 policy, ``ce_chunks=1``, the AdamW kernel) for two warm-up steps, times
two more steps unprofiled, then records one step with ``torch.profiler`` and
prints one JSON line: the step's wall time and tokens/s, peak device memory,
the device time of every kernel class (the hand-written kernels by name,
cuBLAS GEMMs, elementwise, reductions, copies, other), the launch counts of
the hand-written kernels and the device idle share (wall time of the profiled
step minus the sum of kernel times, over the wall time). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ..core.config import GPTConfig, OptimizerConfig, ScheduleConfig
from ..core.precision import DEFAULT_POLICY
from ..models import gpt2
from ..train.optimizer import adamw_init
from ..train.step import make_train_step

# kernel-name fragments -> class, first match wins
CLASSES = (
    ("flash_general_fwd_kernel", "general flash forward"),
    ("flash_general_dq_kernel", "general flash dq"),
    ("flash_general_dkv_kernel", "general flash dk/dv"),
    ("flash_rowdot_kernel", "general flash D"),
    ("flash_fwd_kernel", "self-attention flash forward"),
    ("flash_bwd_", "self-attention flash backward"),
    ("adamw_kernel", "AdamW kernel"),
    ("ce_fwd", "CE forward kernel"),
    ("nvjet", "GEMM"), ("gemm", "GEMM"), ("cutlass", "GEMM"), ("cublas", "GEMM"),
    ("reduce", "reduction"),
    ("elementwise", "elementwise"), ("vectorized", "elementwise"),
    ("Memcpy", "memcpy/memset"), ("Memset", "memcpy/memset"),
)


def classify(name: str) -> str:
    return next((cls for frag, cls in CLASSES if frag in name), "other")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seq-len", type=int, default=16384)
    p.add_argument("--micro-batch", type=int, default=1)
    p.add_argument("--accum", type=int, default=2, help="micro-batches per step")
    p.add_argument("--n-layer", type=int, default=12)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step needs a CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda", 0)
    t, b = args.seq_len, args.micro_batch
    cfg = GPTConfig(block_size=max(1024, t), n_layer=args.n_layer)
    model = gpt2.init(cfg, generator=torch.Generator(dev).manual_seed(1337), device=dev)
    step = make_train_step(
        lambda m, r: gpt2.loss(m, r[:, :-1], cfg, targets=r[:, 1:], policy=DEFAULT_POLICY,
                               ce_chunks=1),
        OptimizerConfig(), ScheduleConfig(), decay_mask=gpt2.decay_mask(model))
    state = adamw_init(gpt2.named_params(model))
    rows = np.random.RandomState(0).randint(0, cfg.vocab_size, (args.accum, b, t + 1))
    batch = torch.from_numpy(rows.astype(np.int32)).to(dev)

    def timed(i):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(model, state, batch, i)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for i in range(2):
        timed(i)
    torch.cuda.reset_peak_memory_stats()
    plain = [timed(i) for i in (2, 3)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = timed(4)
    by_class, launches, total_us = {}, {}, 0.0
    for ev in prof.key_averages():
        # kernel events only: an operator's row repeats its kernels' time
        us = float(getattr(ev, "self_device_time_total", 0.0) or 0.0)
        if ev.device_type != DeviceType.CUDA or us <= 0:
            continue
        cls = classify(ev.key)
        by_class[cls] = by_class.get(cls, 0.0) + us / 1e3
        launches[cls] = launches.get(cls, 0) + ev.count
        total_us += us
    if total_us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    n_tok = args.accum * b * t
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    result = {
        "card": card, "seq_len": t, "micro_batch": b, "accum": args.accum,
        "n_layer": args.n_layer, "tokens_per_step": n_tok,
        "unprofiled_step_s": plain, "tokens_per_s": [n_tok / s for s in plain],
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "profiled_wall_ms": wall * 1e3, "device_kernel_ms": total_us / 1e3,
        "device_idle_share": 1.0 - total_us / 1e3 / (wall * 1e3),
        "device_ms_by_class": dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
        "launches_by_class": launches,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
