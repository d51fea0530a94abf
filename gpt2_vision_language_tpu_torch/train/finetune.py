"""COCO captioning fine-tune workloads: linear / Q-Former / cross-attention.

Counterpart of gpt2_vision_language_tpu/train/finetune.py, on one device or
data-parallel over processes (the three bridge trainers gpt2_linear/train.py, gpt2_q_former/train.py and
gpt2_cross-att/train.py): frozen CLIP features from precomputed shards, frozen
GPT-2 from the pretrain checkpoint, only the bridge (or the cross-attention
leaves) trains.

Reference semantics kept: cadences (val every 20 incl. step 0, CIDEr after
val, rolling/best/final checkpoints), masked labels (y masked to -100 outside
the caption), grad accumulation 524288/(B*T) for linear/qformer and 1 for
xattn, the presets' LR schedules, CSV logging, and CIDEr swallowed on failure
so that training survives an eval crash (gpt2_linear/train.py:253-272).

As in the JAX package the pooled 33-token features of both splits live on the
device as one bank each and a micro-batch gathers its rows there by index;
the token ids of a whole accumulation window cross to the device in one
pinned copy per array, prepared by a background thread; CIDEr runs batched
through the KV-cached decoder. Frozen leaves have requires_grad off, so they
get no gradient work, no moments, and stay out of the AdamW kernel's leaf
table. The Q-Former's dropout draws from one ``torch.Generator`` seeded from
the config (the JAX per-micro seed counter). Unlike the JAX trainer this one
resumes from its own checkpoints, like the port's pretrain trainer.

Data parallelism (``num_devices`` = the processes of ``torch.distributed.
run``): each rank's batcher strides the epoch order (``CocoBatcher(rank,
world)``, ``micro_batch_size`` rows a rank), the masked-mean loss counts the
caption tokens of the whole global micro-batch (``gpt2.fused_ce_loss``'s
``group``), the grads are summed once a step (parallel/collectives.GradSync),
and the Q-Former's dropout masks are the global micro-batch's, each rank
keeping its rows (``bridges.RowShard``), so W ranks compute the one-process
step at the same global batch. CIDEr and sampling run on every rank, as in
JAX; the master logs and writes the checkpoints.
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
from ..ckpt.torch_import import load_gpt_checkpoint
from ..core.config import FinetuneConfig
from ..core.precision import Policy, DEFAULT_POLICY
from ..data.coco import CocoBatcher, CocoClipTokensDataset, build_pooled_feature_bank
from ..data.pipeline import HostPrefetcher
from ..data.tokenizer import get_tokenizer
from ..eval.caption_eval import evaluate_captions
from ..infer.decode import Decoder
from ..infer.sampling import sample_top_p
from ..models import caption, gpt2
from ..models.bridges import RowShard, bridge_decay_mask
from ..obs.csvlog import MetricsLogger
from ..ops.pooling import pool_clip_tokens_to_33
from ..parallel import collectives as coll
from ..parallel.mesh import init_distributed, is_master, make_mesh
from .optimizer import adamw_init
from .step import make_eval_step, make_train_step


def load_pretrained_gpt(cfg, init_ckpt: Optional[str], *, device, seed: int = 0):
    """Bootstrap the LM from a checkpoint with strict=False semantics: leaves
    absent from the checkpoint (the xattn leaves of a plain-decoder
    checkpoint) keep their fresh init (gpt2_cross-att/train.py:89-91). Reads
    the port's own pretrain checkpoints and reference ``.pt`` files (both hold
    the state dict under "model"). ``device`` is where the model is built; the
    caller names it."""
    device = torch.device(device)
    model = gpt2.init(cfg, generator=torch.Generator(device).manual_seed(seed),
                      device=device)
    if not init_ckpt:
        return model
    sd, _ = load_gpt_checkpoint(init_ckpt, cfg)
    missing, _ = model.load_state_dict(sd, strict=False)
    if missing:
        print(f"[init] {len(missing)} leaves not in {init_ckpt} keep their init")
    return model


def batch_to_device(raw, device: torch.device) -> dict:
    """One accumulation window (x, y, mask, idx), each (accum, B, ...) numpy,
    to ``device``: one pinned copy per array."""
    x, y, m, idx = raw

    def put(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            t = t.pin_memory()
        return t.to(device, non_blocking=True)

    return {"x": put(x), "y": put(y), "mask": put(m), "idx": put(idx.astype(np.int64))}


def build_finetune(cfg: FinetuneConfig, *, device, policy: Policy = DEFAULT_POLICY,
                   mesh=None) -> dict:
    """The model, masks and loss functions of one fine-tune on ``device``:
    {"model", "trainable", "decay", "loss_fn", "train_loss_fn", "dropout"}.

    The frozen LM comes from ``load_pretrained_gpt`` (+ a trainable bridge under
    ``bridge.*``, or the cross-attention leaves). ``loss_fn(model, micro, bank)``
    is the validation loss; ``train_loss_fn`` is the same with the Q-Former's
    dropout active, drawn from the seed that the micro-batch carries under
    "seed" (``dropout_seeds``). ``dropout`` says whether the training batches
    must carry those seeds: the other two kinds have no dropout sites. ``micro``
    holds x, y, mask and idx, the rows of ``bank``. ``mesh``: a ("data",)
    parallel/mesh.Mesh of several ranks, this rank holding its rows of each
    micro-batch."""
    device = torch.device(device)
    kind, model_cfg = cfg.bridge.kind, cfg.model
    group = None if mesh is None else mesh.group("data")
    gpt = load_pretrained_gpt(model_cfg, cfg.init_ckpt, seed=cfg.seed, device=device)
    if kind == "xattn":

        def loss_fn(model, micro, bank):
            return gpt2.loss(model, micro["x"], model_cfg, z=bank[micro["idx"]],
                             targets=micro["y"], target_mask=micro["mask"], policy=policy,
                             group=group)

        return {"model": gpt, "trainable": gpt2.trainable_mask_xattn(gpt),
                "decay": gpt2.decay_mask(gpt), "loss_fn": loss_fn, "train_loss_fn": loss_fn,
                "dropout": False}

    bridge = caption.init(
        model_cfg, cfg.bridge,
        generator=torch.Generator(device).manual_seed(cfg.seed + 1), device=device,
    )
    model = caption.CaptionModel(gpt, bridge)
    trainable = {n: n.startswith("bridge.") for n in gpt2.named_params(model)}
    decay = {f"gpt.{n}": d for n, d in gpt2.decay_mask(gpt).items()}
    decay.update({f"bridge.{n}": d for n, d in bridge_decay_mask(bridge).items()})
    # train=True: the Q-Former's dropout is active when a micro-batch carries a
    # generator, which only training batches do
    base_loss = caption.loss_fn_factory(model_cfg, cfg.bridge, policy=policy, train=True,
                                        group=group)
    # the Q-Former's dropout stream, re-seeded for each micro-batch from the
    # seed it carries; the linear bridge has no dropout sites
    dropout_gen = torch.Generator(device) if kind == "qformer" else None

    def loss_fn(model, micro, bank):
        return base_loss(model, {**micro, "z": bank[micro["idx"]]})

    def train_loss_fn(model, micro, bank):
        micro = {**micro, "z": bank[micro["idx"]]}
        if dropout_gen is not None:
            gen = dropout_gen.manual_seed(int(micro.pop("seed")))
            micro["generator"] = gen if group is None else RowShard(
                gen, mesh.coord("data"), mesh.size("data"))
        return base_loss(model, micro)

    return {"model": model, "trainable": trainable, "decay": decay, "loss_fn": loss_fn,
            "train_loss_fn": train_loss_fn, "dropout": dropout_gen is not None}


def dropout_seeds(seed: int, step: int, accum: int) -> torch.Tensor:
    """The dropout seeds of step ``step``'s micro-batches, (accum,): one for
    each global micro-batch index step * accum + i, as the JAX trainer draws
    one seed a micro-batch (gpt2_vision_language_tpu/train/finetune.py:246-263).
    They depend on the position alone, so a resumed run draws what the
    uninterrupted one does."""
    return seed * 1000003 + step * accum + torch.arange(accum)


def run_finetune(cfg: FinetuneConfig, *, device="cuda", policy: Policy = DEFAULT_POLICY,
                 max_steps_override: Optional[int] = None,
                 num_devices: Optional[int] = None) -> dict:
    """Run the fine-tune loop on ``device`` (each rank's, parallel/mesh.
    device_for_rank). Returns {"model", "opt_state", "val_loss", "cider",
    "cfg"}. ``num_devices``: the data-parallel world, the processes of
    ``torch.distributed.run``; checked when given."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "run_finetune: no CUDA device (torch.cuda.is_available() is False); pass "
            "device='cpu' to train on the CPU"
        )
    device = init_distributed(device)
    mesh = make_mesh(num_devices, ("data",))
    rank, world = mesh.coord("data"), mesh.size("data")
    master = is_master()
    accum = cfg.grad_accum_steps(world)
    kind = cfg.bridge.kind
    model_cfg = cfg.model
    if master:
        print(f"[finetune:{kind}] accum={accum} world={world} device={device}")

    tokenizer = get_tokenizer()
    coco_root = cfg.coco_root or os.environ.get("COCO_ROOT", "coco2017")
    feats_dir = cfg.clip_feats_dir or os.environ.get("CLIP_FULL_DIR", "clip_feats_full")

    def dataset(split):
        return CocoClipTokensDataset(
            os.path.join(feats_dir, split),
            os.path.join(coco_root, "annotations", f"captions_{split}2017.json"),
            tokenizer, cfg.seq_len, seed=cfg.seed,
        )

    train_ds, val_ds = dataset("train"), dataset("val")
    b = cfg.micro_batch_size  # rows a rank; the global micro-batch is b * world
    train_batcher = CocoBatcher(train_ds, b, shuffle=True, drop_last=True, seed=cfg.seed,
                                rank=rank, world=world)
    val_batcher = CocoBatcher(val_ds, b, shuffle=False, drop_last=False, seed=cfg.seed,
                              rank=rank, world=world)

    # device-resident pooled feature banks: the CLIP-feature transfer is paid
    # once, rows are gathered on the device per micro-batch
    t_bank = time.time()
    train_bank = build_pooled_feature_bank(train_ds, pool_clip_tokens_to_33,
                                           dtype=policy.compute_dtype, device=device)
    val_bank = build_pooled_feature_bank(val_ds, pool_clip_tokens_to_33,
                                         dtype=policy.compute_dtype, device=device)
    gb_bytes = train_bank.numel() * train_bank.element_size() / 1e9
    print(f"[feats] pooled banks on device: train {tuple(train_bank.shape)} "
          f"({gb_bytes:.2f} GB), val {tuple(val_bank.shape)} in {time.time() - t_bank:.1f}s")

    parts = build_finetune(cfg, device=device, policy=policy,
                           mesh=mesh if world > 1 else None)
    model, trainable, decay = parts["model"], parts["trainable"], parts["decay"]
    loss_fn, train_loss_fn = parts["loss_fn"], parts["train_loss_fn"]
    dropout = parts["dropout"]

    params = gpt2.named_params(model)
    n_train = sum(p.numel() for n, p in params.items() if trainable[n])
    n_total = gpt2.param_count(model)
    if master:
        print(f"[init] trainable params: {n_train}/{n_total}")

    # the frozen decoder gets no moments (~1 GB of device memory and the same
    # in every checkpoint at 124M)
    opt_state = adamw_init(params, trainable_mask=trainable)
    # the losses are masked means over the whole global micro-batch: the
    # grads are summed over the ranks, not averaged
    sync = coll.GradSync(mesh, loss_is_global=True) if world > 1 else None
    train_step = make_train_step(train_loss_fn, cfg.optimizer, cfg.schedule,
                                 decay_mask=decay, trainable_mask=trainable, grad_sync=sync)
    eval_step = make_eval_step(loss_fn)

    log = MetricsLogger(cfg.log_dir, is_master=master)
    log.meta("tokenizer", tokenizer.name)
    log.meta("argv", " ".join(sys.argv))
    manager = CheckpointManager(os.path.join(log.log_dir, "ckpts"), save_every=cfg.save_every,
                                is_master=master)
    # the sorted sampler: it keeps the sort-free one's set and took 0.57-0.90
    # ms a call on the H100 against 13.1-19.9 ms (infer/sampling.py)
    cider_decoder = Decoder(model_cfg, policy=policy, sample_fn=sample_top_p)

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
        train_batcher.skip_batches(start_step * accum)
        if master:
            print(f"[ckpt] resumed at step {start_step}")

    max_steps = max_steps_override or cfg.schedule.max_steps
    val_loss, cider = float("nan"), None
    tokens_per_step = b * world * cfg.seq_len * accum
    avg_dt = None

    def run_validation(step, last_step):
        nonlocal val_loss, cider
        # the same leading val window every time (the reference iterates a
        # fresh val_loader each validation, gpt2_linear/train.py:225)
        val_batcher.reset()
        raw = val_batcher.next_accum_index_batch(cfg.val_steps)
        val_loss = float(eval_step(model, batch_to_device(raw, device), val_bank))
        log.val(step, val_loss)
        manager.save_step(step, model, opt_state, val_loss, last_step=last_step)
        # cider_every gates the generation eval independently of the val loss
        # (0 disables; the reference couples both at 20 steps,
        # gpt2_linear/train.py:218-273)
        if not (cfg.cider_every and (step % cfg.cider_every == 0 or last_step)):
            return
        try:
            out = evaluate_captions(
                model, val_ds, model_cfg, None if kind == "xattn" else cfg.bridge,
                tokenizer, max_samples=cfg.cider_samples,
                max_new_tokens=cfg.cider_max_new_tokens, policy=policy,
                feature_bank=val_bank, decoder=cider_decoder,
            )
            cider = out["cider"]
            log.cider(step, cider)
        except Exception as e:  # noqa: BLE001 — reference parity:
            # training survives eval crashes (gpt2_linear/train.py:271)
            print(f"[CIDEr] evaluation failed at step {step}: {e}")

    prefetch = HostPrefetcher(
        lambda: train_batcher.next_accum_index_batch(accum),
        stage=lambda raw: batch_to_device(raw, device),
    )

    final_step, halted = start_step - 1, False
    try:
        for step in range(start_step, max_steps):
            t0 = time.time()
            last_step = step == max_steps - 1
            # val_every=0 disables validation (same convention as pretrain)
            if cfg.val_every and (step % cfg.val_every == 0 or last_step):
                run_validation(step, last_step)

            batch = prefetch.next()
            if dropout:
                batch = {**batch, "seed": dropout_seeds(cfg.seed, step, accum)}
            metrics = train_step(model, opt_state, batch, step, train_bank)
            final_step = step
            if not (math.isfinite(metrics["loss"]) and math.isfinite(metrics["grad_norm"])):
                print(f"[guard] non-finite loss/grad at step {step}; halting")
                halted = True
                break
            dt = time.time() - t0
            avg_dt = dt if avg_dt is None else 0.9 * avg_dt + 0.1 * dt
            log.train(step, metrics["loss"], metrics["lr"], metrics["grad_norm"],
                      dt * 1000, tokens_per_step / dt,
                      eta_sec=(max_steps - step - 1) * avg_dt)
    finally:
        prefetch.close()

    # record the last step actually run, not the scheduled end
    next_step = final_step if halted else final_step + 1
    manager.save_final(final_step, model, opt_state, val_loss, next_step=next_step)
    if master:
        log.export_xlsx()
    return {"model": model, "opt_state": opt_state, "val_loss": val_loss, "cider": cider,
            "cfg": cfg}
