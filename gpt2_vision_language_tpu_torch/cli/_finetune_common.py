"""Shared argparse plumbing for the three fine-tune CLIs.

Counterpart of gpt2_vision_language_tpu/cli/_finetune_common.py: the same
flags plus ``--device`` (default ``cuda``: without a CUDA device the run
raises unless ``--device cpu`` asks for the CPU).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from ..data.coco import write_synthetic_coco


def build_parser(doc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=doc)
    p.add_argument("--steps", type=int, default=None, help="override max_steps")
    p.add_argument("--init-ckpt", type=str, default=None,
                   help="pretrained GPT-2 checkpoint (.pt: this package's or the reference's)")
    p.add_argument("--coco-root", type=str, default=None)
    p.add_argument("--clip-feats", type=str, default=None)
    p.add_argument("--log-dir", type=str, default=None)
    p.add_argument("--micro-batch", type=int, default=None)
    p.add_argument("--devices", type=int, default=None,
                   help="only 1 is supported (data parallelism is not ported)")
    p.add_argument("--device", default="cuda",
                   help="device to train on: 'cuda' (default; raises without a CUDA "
                   "device) or 'cpu'")
    p.add_argument(
        "--synthetic", action="store_true",
        help="generate a synthetic COCO+CLIP dataset in a temp dir",
    )
    return p


def apply_common(cfg, args):
    updates = {}
    if args.init_ckpt:
        updates["init_ckpt"] = args.init_ckpt
    if args.coco_root:
        updates["coco_root"] = args.coco_root
    if args.clip_feats:
        updates["clip_feats_dir"] = args.clip_feats
    if args.log_dir:
        updates["log_dir"] = args.log_dir
    if args.micro_batch:
        updates["micro_batch_size"] = args.micro_batch
    if args.synthetic:
        root = tempfile.mkdtemp(prefix="coco_synthetic_")
        enc_dim = cfg.model.img_embd if cfg.bridge.kind == "xattn" else cfg.bridge.enc_dim
        write_synthetic_coco(root, split="train", n_images=256, n_tokens=197, enc_dim=enc_dim)
        write_synthetic_coco(root, split="val", n_images=64, n_tokens=197, enc_dim=enc_dim)
        updates["coco_root"] = root
        updates["clip_feats_dir"] = os.path.join(root, "clip_feats")
    return dataclasses.replace(cfg, **updates)


def with_model(cfg, model, bridge=None):
    """``cfg`` with a smaller architecture (test runs): the GPT config, and for
    the prefix bridges the bridge config."""
    updates = {}
    if model is not None:
        updates["model"] = model
    if bridge is not None:
        updates["bridge"] = bridge
    return dataclasses.replace(cfg, **updates)


def run(cfg, args, *, overrides=None):
    """Run the trainer on ``--device``; ``overrides`` replaces FinetuneConfig
    fields (cadences, for short runs)."""
    from ..train.finetune import run_finetune

    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return run_finetune(cfg, device=args.device, max_steps_override=args.steps,
                        num_devices=args.devices)


def make_main(preset, doc: str):
    """The ``main`` of a prefix-bridge CLI (linear, Q-Former) over ``preset``."""

    def main(argv=None, *, model=None, bridge=None, overrides=None) -> dict:
        """``model`` / ``bridge`` replace the 124M architecture and the bridge
        config (smaller test runs)."""
        args = build_parser(doc).parse_args(argv)
        return run(apply_common(with_model(preset(), model, bridge), args), args,
                   overrides=overrides)

    return main
