"""CLI: profile one GPT-2 train step on the CUDA device, by kernel.

    python -m gpt2_vision_language_tpu_torch.cli.profile_step \
        [--seq-len 16384] [--micro-batch 1] [--accum 2] [--n-layer 12] \
        [--attn-impl ring --tp 4]
    python -m gpt2_vision_language_tpu_torch.cli.profile_step \
        --finetune {linear,qformer,xattn} [--accum 4]

Builds GPT-2 124M with seeded random weights (``block_size`` grown to
``--seq-len``), runs ``train.step.make_train_step`` on a seeded random batch
(bf16 policy, ``ce_chunks=1``, the AdamW kernel) for two warm-up steps, times
two more steps unprofiled, then records one step with ``torch.profiler`` and
prints one JSON line: the step's wall time and tokens/s, peak device memory,
the device time of every kernel class (the hand-written kernels by name,
cuBLAS GEMMs, elementwise, reductions, copies, other), the launch counts of
the hand-written kernels and the device idle share (wall time of the profiled
step minus the sum of kernel times, over the wall time; and the same against
the unprofiled steps, which the profiler does not slow). With ``--attn-impl
ring --tp N`` every self-attention is a ring of N sequence chunks, and the
library kernels (elementwise, reductions, copies) launched by operators on
chunk-shaped tensors, forward and backward, are one class of their own, "ring
glue": the merges of the partial results, their casts, the split and the
concatenation. With ``--finetune KIND`` the step is that caption fine-tune's
(``train/finetune.build_finetune`` of its preset: GPT-2 124M frozen, B=128,
T=32 text tokens after the visual prefix, a seeded random feature bank and
batch, ``--accum`` micro-batches) and tokens count text tokens, as its log
does. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ..core.config import (
    GPTConfig, OptimizerConfig, ScheduleConfig, finetune_linear_preset,
    finetune_qformer_preset, finetune_xattn_preset,
)
from ..core.precision import DEFAULT_POLICY
from ..models import gpt2
from ..ops import ring_attention
from ..train.finetune import build_finetune, dropout_seeds
from ..train.optimizer import adamw_init
from ..train.step import make_train_step

# kernel-name fragments -> class, first match wins; the hand-written kernels first
HAND_WRITTEN_CLASSES = (
    ("flash_lse_fwd_kernel", "lse flash forward"),
    ("flash_fused_bwd_kernel", "one-pass flash backward"),
    ("flash_fused_dq_cast_kernel", "one-pass flash backward dq cast"),
    ("flash_general_fwd_kernel", "general flash forward"),
    ("flash_general_dq_kernel", "general flash dq"),
    ("flash_general_dkv_kernel", "general flash dk/dv"),
    ("flash_rowdot_kernel", "flash D pre-kernel"),  # the general and the self-attention backward
    ("flash_fwd_kernel", "self-attention flash forward"),
    ("flash_bwd_", "self-attention flash backward"),
    ("adamw_kernel", "AdamW kernel"),
    ("ce_fwd", "CE forward kernel"),
    ("ce_bwd", "CE backward kernel"),
)
CLASSES = HAND_WRITTEN_CLASSES + (
    ("nvjet", "GEMM"), ("gemm", "GEMM"), ("cutlass", "GEMM"), ("cublas", "GEMM"),
    ("reduce", "reduction"),
    ("elementwise", "elementwise"), ("vectorized", "elementwise"),
    ("Memcpy", "memcpy/memset"), ("Memset", "memcpy/memset"),
)


HAND_WRITTEN = {cls for _, cls in HAND_WRITTEN_CLASSES}
RING_GLUE = "ring glue"


def classify(name: str) -> str:
    return next((cls for frag, cls in CLASSES if frag in name), "other")


def ring_glue_ms(events, chunk: int) -> tuple[float, int]:
    """(device ms, launches) of the library kernels launched by operators
    with an input whose second axis is one ring chunk long: (B, T/n, H, hs)
    and (B, T/n, H, 1) are the shapes of the ring's partial results, and no
    other tensor of the step has that length. Needs record_shapes."""
    us, count = 0.0, 0
    for ev in events:
        if not ev.kernels:
            continue
        shapes = [s for s in (ev.input_shapes or []) if isinstance(s, (list, tuple))]
        if not any(len(s) >= 3 and s[1] == chunk for s in shapes):
            continue
        for k in ev.kernels:
            if classify(k.name) not in HAND_WRITTEN:
                us += k.duration
                count += 1
    return us / 1e3, count


FINETUNE_PRESETS = {"linear": finetune_linear_preset, "qformer": finetune_qformer_preset,
                    "xattn": finetune_xattn_preset}


def pretrain_step(args, dev):
    """(step(i), tokens per step, extra result fields) of the pretrain step."""
    t, b = args.seq_len, args.micro_batch
    cfg = GPTConfig(block_size=max(1024, t), n_layer=args.n_layer)
    model = gpt2.init(cfg, generator=torch.Generator(dev).manual_seed(1337), device=dev)
    step = make_train_step(
        lambda m, r: gpt2.loss(m, r[:, :-1], cfg, targets=r[:, 1:], policy=DEFAULT_POLICY,
                               attn_impl=args.attn_impl, ce_chunks=1),
        OptimizerConfig(), ScheduleConfig(), decay_mask=gpt2.decay_mask(model))
    state = adamw_init(gpt2.named_params(model))
    rows = np.random.RandomState(0).randint(0, cfg.vocab_size, (args.accum, b, t + 1))
    batch = torch.from_numpy(rows.astype(np.int32)).to(dev)
    return (lambda i: step(model, state, batch, i)), args.accum * b * t, {
        "seq_len": t, "micro_batch": b, "n_layer": args.n_layer, "attn_impl": args.attn_impl,
        "tp": args.tp}


def finetune_step(args, dev):
    """The same of one caption fine-tune's step at its preset's shape."""
    cfg = FINETUNE_PRESETS[args.finetune]()
    parts = build_finetune(cfg, device=dev)
    model, trainable = parts["model"], parts["trainable"]
    step = make_train_step(parts["train_loss_fn"], cfg.optimizer, cfg.schedule,
                           decay_mask=parts["decay"], trainable_mask=trainable)
    params = gpt2.named_params(model)
    state = adamw_init(params, trainable_mask=trainable)
    b, t, n_bank = cfg.micro_batch_size, cfg.seq_len, 256
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.model.vocab_size, (args.accum, b, t + 1))
    mask = np.arange(t)[None, None, :] < rng.randint(4, t, (args.accum, b, 1))
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
             for k, v in (("x", toks[..., :-1]), ("y", toks[..., 1:]), ("mask", mask),
                          ("idx", rng.randint(0, n_bank, (args.accum, b))))}
    if parts["dropout"]:
        batch["seed"] = dropout_seeds(cfg.seed, 0, args.accum)
    g = torch.Generator(dev).manual_seed(1)
    bank = torch.nn.functional.normalize(
        torch.randn(n_bank, 33, cfg.bridge.enc_dim, device=dev, generator=g), dim=-1
    ).to(DEFAULT_POLICY.compute_dtype)
    return (lambda i: step(model, state, batch, i, bank)), args.accum * b * t, {
        "finetune": args.finetune, "micro_batch": b, "seq_len": t,
        "trainable_params": sum(p.numel() for n, p in params.items() if trainable[n]),
        "total_params": sum(p.numel() for p in params.values())}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seq-len", type=int, default=16384)
    p.add_argument("--micro-batch", type=int, default=1)
    p.add_argument("--accum", type=int, default=2, help="micro-batches per step")
    p.add_argument("--n-layer", type=int, default=12)
    p.add_argument("--attn-impl", choices=["auto", "xla", "flash", "ring"], default="auto")
    p.add_argument("--tp", type=int, default=1,
                   help="with --attn-impl ring: the ring size (sequence chunks)")
    p.add_argument("--finetune", choices=sorted(FINETUNE_PRESETS), default=None,
                   help="profile this caption fine-tune's step instead of the pretrain step")
    args = p.parse_args(argv)
    if (args.attn_impl == "ring") != (args.tp > 1) or args.seq_len % args.tp:
        raise ValueError("--attn-impl ring needs --tp > 1 dividing --seq-len, and --tp "
                         "needs --attn-impl ring")
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step needs a CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda", 0)
    step, n_tok, what = (finetune_step if args.finetune else pretrain_step)(args, dev)

    ring_attention.set_ring(args.tp if args.attn_impl == "ring" else None)

    def timed(i):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(i)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for i in range(2):
        timed(i)
    torch.cuda.reset_peak_memory_stats()
    plain = [timed(i) for i in (2, 3)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        wall = timed(4)
    ring_attention.set_ring(None)
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
    if args.attn_impl == "ring":
        # its kernels are counted above under elementwise, reduction, copies or other
        by_class[RING_GLUE], launches[RING_GLUE] = ring_glue_ms(prof.events(),
                                                                args.seq_len // args.tp)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    result = {
        "card": card, **what, "accum": args.accum, "tokens_per_step": n_tok,
        "unprofiled_step_s": plain, "tokens_per_s": [n_tok / s for s in plain],
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "profiled_wall_ms": wall * 1e3, "device_kernel_ms": total_us / 1e3,
        "device_idle_share": 1.0 - total_us / 1e3 / (wall * 1e3),
        # the profiler slows the host (record_shapes, thousands of small launches):
        # the same kernel time against the unprofiled steps' mean wall time
        "device_idle_share_of_unprofiled_step": 1.0 - total_us / 1e6 / (sum(plain) / len(plain)),
        "device_ms_by_class": dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
        "launches_by_class": launches,
    }
    if args.attn_impl == "ring":
        result["note"] = (f"'{RING_GLUE}' is a subset of the library-kernel classes, not "
                          "an addition to them")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
