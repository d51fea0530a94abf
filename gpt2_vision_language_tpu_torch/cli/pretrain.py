"""CLI: GPT-2 124M FineWeb-Edu pretraining on one device.

    python -m gpt2_vision_language_tpu_torch.cli.pretrain [--steps N] [--synthetic]
        [--model {124M,350M,774M,1558M}] [--val-every N] [--sample-every N]
        [--no-ckpt] [--no-nan-guard]

Counterpart of gpt2_vision_language_tpu/cli/pretrain.py with the flags the
single-device trainer honors. Runs on the first CUDA device (``--device``,
default ``cuda``), where every update goes through the hand-written AdamW
kernel; without a CUDA device it raises unless ``--device cpu`` asks for the
CPU. ``--seq-len`` over 1024 grows the model's ``block_size`` with it
(long-context pretraining: ``--seq-len 16384 --micro-batch 1`` runs every
self-attention on the general flash kernels; with ``--attn-impl ring --tp 4``
as a ring of 4 sequence chunks on the lse-forward and one-pass backward
kernels). Env: FW_OUT_DIR (token shards), LOG_DIR, HELLASWAG_DIR,
GPT2_BPE_DIR.
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile
from typing import Optional

import torch

from ..core.config import GPT2_350M, GPT2_774M, GPT2_1558M, GPTConfig, PretrainConfig
from ..data.fineweb import write_synthetic_corpus
from ..train.pretrain import check_parallel, run_pretrain


def parse_and_build(argv=None, *, model: Optional[GPTConfig] = None):
    """Parse argv into (PretrainConfig, args) without running anything.
    ``model`` replaces the architecture that ``--model`` names (smaller test
    runs) and wins over it."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=None, help="override max_steps")
    p.add_argument(
        "--model", choices=["124M", "350M", "774M", "1558M"], default="124M",
        help="GPT-2 family preset (core/config.py); 124M is the reference workload",
    )
    p.add_argument("--micro-batch", type=int, default=None)
    p.add_argument("--seq-len", type=int, default=None)
    p.add_argument(
        "--block-size", type=int, default=None,
        help="model context length (wpe rows); the reference is fixed at 1024 "
        "(train_gpt2.py:79), larger values are the long-context extension. "
        "Defaults to --seq-len when that exceeds the preset's 1024",
    )
    p.add_argument("--total-batch", type=int, default=None)
    p.add_argument("--no-hellaswag", action="store_true")
    p.add_argument("--val-every", type=int, default=None,
                   help="0 disables validation (and its checkpoint save) entirely")
    p.add_argument("--no-ckpt", action="store_true",
                   help="disable checkpointing entirely (no save, no resume)")
    p.add_argument("--no-nan-guard", action="store_true",
                   help="apply the update of a step with a non-finite loss or grad "
                   "norm instead of skipping it; the loop still halts on it")
    p.add_argument("--save-every", type=int, default=None)
    p.add_argument("--log-dir", default=None,
                   help="CSV/checkpoint output directory (default: $LOG_DIR or ./log)")
    p.add_argument("--sample-every", type=int, default=None,
                   help="0 disables sampling entirely (incl. the final step)")
    p.add_argument(
        "--attn-impl", choices=["auto", "xla", "flash", "ring"], default="auto",
        help="attention path: 'flash' is the hand-written kernels on a CUDA "
        "device (the general streamed-K/V family past T = 8192), 'xla' plain "
        "einsum attention, 'auto' flash for T >= 512 on a CUDA device; 'ring' "
        "ring attention over --tp sequence chunks (requires --tp > 1 and "
        "seq_len %% tp == 0)",
    )
    p.add_argument(
        "--tp", type=int, default=1,
        help="with --attn-impl ring: the ring size, the number of sequence chunks "
        "(the JAX CLI's tensor-parallel degree, whose mesh axis its ring runs over); "
        "Megatron tensor parallelism itself is not ported",
    )
    p.add_argument("--device", default="cuda",
                   help="device to train on: 'cuda' (default; raises without a CUDA "
                   "device) or 'cpu'")
    p.add_argument("--synthetic", action="store_true",
                   help="generate a synthetic token corpus in a temp dir (smoke runs)")
    p.add_argument("--synthetic-kind", choices=["zipf", "markov"], default="zipf")
    p.add_argument("--synthetic-shards", type=int, default=2,
                   help="number of 1M-token train shards to generate")
    args = p.parse_args(argv)

    cfg = PretrainConfig()
    updates = {}
    if model is not None:
        updates["model"] = model
    elif args.model != "124M":
        updates["model"] = {"350M": GPT2_350M, "774M": GPT2_774M,
                            "1558M": GPT2_1558M}[args.model]
    if args.micro_batch:
        updates["micro_batch_size"] = args.micro_batch
    if args.seq_len:
        updates["seq_len"] = args.seq_len
    block = args.block_size
    if block is None and args.seq_len and args.seq_len > 1024:
        block = args.seq_len
    if block:
        updates["model"] = updates.get("model", cfg.model).replace(block_size=block)
    if args.total_batch:
        updates["total_batch_size"] = args.total_batch
    if args.no_hellaswag:
        updates["run_hellaswag"] = False
    if args.val_every is not None:
        updates["val_every"] = args.val_every
    if args.no_ckpt:
        updates["save_ckpt"] = False
    if args.no_nan_guard:
        updates["nan_guard"] = False
    if args.save_every is not None:
        updates["save_every"] = args.save_every
    if args.log_dir:
        updates["log_dir"] = args.log_dir
    if args.sample_every is not None:
        updates["sample_every"] = args.sample_every
    if args.tp != 1:
        updates["tp"] = args.tp
    if args.attn_impl != "auto":
        updates["attn_impl"] = args.attn_impl
    if args.synthetic:
        d = tempfile.mkdtemp(prefix="fineweb_synthetic_")
        write_synthetic_corpus(d, kind=args.synthetic_kind, n_train=args.synthetic_shards)
        updates["data_dir"] = d
    cfg = dataclasses.replace(cfg, **updates)
    check_parallel(cfg)
    return cfg, args


def main(argv=None, *, model: Optional[GPTConfig] = None) -> dict:
    """Run the trainer on the device that ``--device`` names."""
    cfg, args = parse_and_build(argv, model=model)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "cli.pretrain: no CUDA device (torch.cuda.is_available() is False); pass "
            "--device cpu to train on the CPU"
        )
    return run_pretrain(cfg, device=device, max_steps_override=args.steps)


if __name__ == "__main__":
    main()
