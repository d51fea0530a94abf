"""CLI: GPT-2 124M FineWeb-Edu pretraining, on one device or over processes.

    python -m gpt2_vision_language_tpu_torch.cli.pretrain [--steps N] [--synthetic]
        [--model {124M,350M,774M,1558M}] [--val-every N] [--sample-every N]
        [--no-ckpt] [--no-nan-guard] [--opt-state-dtype {float32,bfloat16,int8}]
        [--param-dtype {float32,bfloat16}] [--grad-accum-dtype {float32,bfloat16}]
        [--remat {none,full,save_attn,recompute_gelu,recompute_mlp}]
        [--layerwise-grad] [--fit-1chip] [--devices N] [--tp N] [--seq-parallel]
        [--pp N] [--pp-micro N]

    python -m torch.distributed.run --nproc_per_node 2 \
        -m gpt2_vision_language_tpu_torch.cli.pretrain --devices 2 [--tp 2 | --pp 2] ...

Counterpart of gpt2_vision_language_tpu/cli/pretrain.py with the flags the
trainer honors. Runs on the first CUDA device (``--device``, default
``cuda``), where every update goes through the hand-written AdamW kernel;
without a CUDA device it raises unless ``--device cpu`` asks for the CPU.
Launched by ``torch.distributed.run``, each process is one device of a
("data", "model") mesh, or with ``--pp`` of a ("data", "pipe"[, "model"])
mesh (the GPipe pipeline, a stage of n_layer / pp layers a process):
``--device cuda`` gives local rank i the card ``cuda:i`` and NCCL,
``--device cuda:0`` puts every rank on that one card over gloo, ``--device
cpu`` runs them on the CPU over gloo; ``--devices`` must equal the number of
processes. ``--seq-len`` over 1024 grows the model's ``block_size`` with it
(long-context pretraining: ``--seq-len 16384 --micro-batch 1`` runs every
self-attention on the general flash kernels; with ``--attn-impl ring --tp 4``
as a ring of 4 sequence chunks on the lse-forward and one-pass backward
kernels, over 4 processes inside Megatron-sharded attention, with
``--seq-parallel`` or ``--layerwise-grad`` as under ``--tp``). The memory
recipes are the JAX CLI's flags; ``--fit-1chip`` fills in the stack of
``FIT_1CHIP`` for the chosen ``--model``, the H100's own table. Env:
FW_OUT_DIR (token shards), LOG_DIR, HELLASWAG_DIR, GPT2_BPE_DIR.
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

# --fit-1chip: the least memory-mechanism stack that fits each GPT-2 preset's
# full 524,288-token batch (micro-batches of 8 x 1024) on one 80 GB H100, from
# chip_smoke.py phase 31's reading of the peak device memory of a step of two
# micro-batches under each stack. On NVIDIA H100 80GB HBM3 at 700.00 W no
# preset needs a mechanism: 1558M peaks at 43.76 GiB with fp32 params, moments
# and grads and no remat (B=16 at 63.40), 774M at 24.27 GiB, out of 79.2 GiB
# (phase 31 (b)). The JAX table's rows were read on a 16 GB chip, and its
# TPU-only mechanisms (pin_layouts, split_accum) are not carried. Explicit
# flags win: these only fill what the user left unset.
FIT_1CHIP = {
    "124M": {},
    "350M": {},
    "774M": {},
    "1558M": {},
}


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
        "rotates K/V over the model axis, --tp sequence chunks (requires --tp > 1 "
        "and seq_len %% tp == 0)",
    )
    p.add_argument("--devices", type=int, default=None)
    p.add_argument(
        "--tp", type=int, default=1,
        help="model-axis size: builds a 2-D (data, model) mesh and applies "
        "Megatron column/row parameter shardings (parallel/sharding.py). "
        "1 = pure DP (the reference's only mode)",
    )
    p.add_argument(
        "--pp", type=int, default=1,
        help="pipeline stages: builds a 2-D (data, pipe) mesh and runs "
        "the blocks through the GPipe schedule with layers stage-sharded "
        "on the pipe axis (parallel/pipeline.py). Requires n_layer %% pp "
        "== 0; composes with --tp (Megatron sharding inside each stage)",
    )
    p.add_argument(
        "--pp-micro", type=int, default=0,
        help="GPipe microbatches per grad-accum micro (0 = pp); larger "
        "values shrink the (pp-1)/(pp_micro+pp-1) bubble",
    )
    p.add_argument(
        "--seq-parallel", action="store_true",
        help="with --tp > 1: T-shard the residual stream over the model "
        "axis between blocks (reduce-scatter + all-gather instead of "
        "all-reduce; Korthikanti et al.)",
    )
    p.add_argument("--device", default="cuda",
                   help="device to train on: 'cuda' (default; raises without a CUDA "
                   "device; under torch.distributed.run one card a rank), 'cuda:N' "
                   "(every rank on card N) or 'cpu'")
    p.add_argument("--synthetic", action="store_true",
                   help="generate a synthetic token corpus in a temp dir (smoke runs)")
    p.add_argument("--synthetic-kind", choices=["zipf", "markov"], default="zipf")
    p.add_argument("--synthetic-shards", type=int, default=2,
                   help="number of 1M-token train shards to generate")
    p.add_argument(
        "--layerwise-grad", action="store_true",
        help="form each micro-batch's grads layer by layer and fold them into the "
        "accumulators at once (models/gpt2.py loss_grad_layerwise): peak gradient "
        "memory is one layer's, every block's forward runs twice",
    )
    p.add_argument(
        "--opt-state-dtype", choices=["float32", "bfloat16", "int8"], default=None,
        help="AdamW m/v storage dtype; bfloat16 halves the optimizer state, int8 "
        "block-quantizes the moments (Dettmers-style). Update math stays fp32",
    )
    p.add_argument(
        "--param-dtype", choices=["float32", "bfloat16"], default=None,
        help="master parameter dtype; bfloat16 = the torch reference's whole-model "
        "CUDA cast (train_gpt2.py:264)",
    )
    p.add_argument(
        "--grad-accum-dtype", choices=["float32", "bfloat16"], default=None,
        help="grad accumulator dtype; bfloat16 halves the accumulators by unbiased "
        "stochastic rounding",
    )
    p.add_argument(
        "--remat", choices=["none", "full", "save_attn", "recompute_gelu", "recompute_mlp"],
        default=None,
        help="activation rematerialization policy (models/gpt2.py run_blocks). "
        "Default: none",
    )
    p.add_argument(
        "--fit-1chip", action="store_true",
        help="apply the measured memory-mechanism stack that fits the chosen --model "
        "preset's full batch on one 80 GB H100 (FIT_1CHIP). Explicit flags override",
    )
    args = p.parse_args(argv)
    if args.fit_1chip:
        for k, v in FIT_1CHIP[args.model].items():
            if not getattr(args, k):  # the user's explicit flag wins
                setattr(args, k, v)
    if args.remat is None:
        args.remat = "none"

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
    if args.layerwise_grad:
        updates["layerwise_grad"] = True
    if args.opt_state_dtype:
        updates["opt_state_dtype"] = args.opt_state_dtype
    if args.grad_accum_dtype:
        updates["grad_accum_dtype"] = args.grad_accum_dtype
    if args.param_dtype:
        updates["param_dtype"] = args.param_dtype
    if args.tp != 1:
        updates["tp"] = args.tp
    if args.pp != 1:
        updates["pp"] = args.pp
    if args.pp_micro:
        updates["pp_micro"] = args.pp_micro
    if args.seq_parallel:
        updates["seq_parallel"] = True
    if args.attn_impl != "auto":
        updates["attn_impl"] = args.attn_impl
    if args.synthetic:
        d = tempfile.mkdtemp(prefix="fineweb_synthetic_")
        write_synthetic_corpus(d, kind=args.synthetic_kind, n_train=args.synthetic_shards)
        updates["data_dir"] = d
    cfg = dataclasses.replace(cfg, **updates)
    check_parallel(cfg)
    return cfg, args


def remat_of(args) -> object:
    """The remat argument of run_pretrain from the parsed ``--remat``: False,
    True or a mode name, as the JAX parse_and_build returns it."""
    return {"none": False, "full": True}.get(args.remat, args.remat)


def main(argv=None, *, model: Optional[GPTConfig] = None) -> dict:
    """Run the trainer on the device that ``--device`` names."""
    cfg, args = parse_and_build(argv, model=model)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "cli.pretrain: no CUDA device (torch.cuda.is_available() is False); pass "
            "--device cpu to train on the CPU"
        )
    return run_pretrain(cfg, device=device, max_steps_override=args.steps,
                        remat=remat_of(args), num_devices=args.devices)


if __name__ == "__main__":
    main()
