"""CLI: GPT-2 124M FineWeb-Edu pretraining on one device.

    python -m gpt2_vision_language_tpu_torch.cli.pretrain [--steps N] [--synthetic]

Counterpart of gpt2_vision_language_tpu/cli/pretrain.py with the flags the
single-device trainer honors. Runs on the first CUDA device, where every
update goes through the hand-written AdamW kernel, or on the CPU where
there is none. ``--seq-len`` over 1024 grows the model's ``block_size`` with
it (long-context pretraining: ``--seq-len 16384 --micro-batch 1`` runs every
self-attention on the general flash kernels). Env: FW_OUT_DIR (token
shards), LOG_DIR, HELLASWAG_DIR, GPT2_BPE_DIR.
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile
from typing import Optional

import torch

from ..core.config import GPTConfig, PretrainConfig
from ..data.fineweb import write_synthetic_corpus


def parse_and_build(argv=None, *, model: Optional[GPTConfig] = None):
    """Parse argv into (PretrainConfig, args) without running anything.
    ``model`` replaces the GPT-2 124M architecture (smaller test runs)."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=None, help="override max_steps")
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
    p.add_argument("--save-every", type=int, default=None)
    p.add_argument("--log-dir", default=None,
                   help="CSV/checkpoint output directory (default: $LOG_DIR or ./log)")
    p.add_argument(
        "--attn-impl", choices=["auto", "xla", "flash", "ring"], default="auto",
        help="attention path: 'flash' is the hand-written kernels on a CUDA "
        "device (the general streamed-K/V family past T = 8192), 'xla' plain "
        "einsum attention, 'auto' flash for T >= 512 on a CUDA device; 'ring' "
        "is not ported yet",
    )
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
    if args.save_every is not None:
        updates["save_every"] = args.save_every
    if args.log_dir:
        updates["log_dir"] = args.log_dir
    if args.attn_impl == "ring":
        raise NotImplementedError(
            "--attn-impl ring: ring attention is not ported yet (ROADMAP Queue 1 "
            "item 10, with the parallel styles)"
        )
    if args.attn_impl != "auto":
        updates["attn_impl"] = args.attn_impl
    if args.synthetic:
        d = tempfile.mkdtemp(prefix="fineweb_synthetic_")
        write_synthetic_corpus(d, kind=args.synthetic_kind, n_train=args.synthetic_shards)
        updates["data_dir"] = d
    return dataclasses.replace(cfg, **updates), args


def main(argv=None, *, model: Optional[GPTConfig] = None) -> dict:
    cfg, args = parse_and_build(argv, model=model)

    from ..train.pretrain import run_pretrain

    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    return run_pretrain(cfg, device=device, max_steps_override=args.steps)


if __name__ == "__main__":
    main()
