"""CLI: gated cross-attention COCO fine-tune (reference: source/gpt2_cross-att/train.py).

    python -m gpt2_vision_language_tpu_torch.cli.finetune_xattn --init-ckpt ... [--synthetic]

Counterpart of gpt2_vision_language_tpu/cli/finetune_xattn.py. max_steps
defaults to one epoch of the train set (computed after the dataset is known),
accum=1, lr 1e-3 -> 1e-5, warmup 20. Runs on the first CUDA device unless
``--device cpu``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os

from ..core.config import finetune_xattn_preset
from ._finetune_common import apply_common, build_parser, run, with_model


def main(argv=None, *, model=None, overrides=None) -> dict:
    """``model`` replaces the 124M cross-attention architecture (smaller test
    runs)."""
    args = build_parser(__doc__).parse_args(argv)
    cfg = apply_common(with_model(finetune_xattn_preset(), model), args)
    # recompute 1-epoch max_steps from the actual dataset size
    ann = os.path.join(
        cfg.coco_root or os.environ.get("COCO_ROOT", "coco2017"),
        "annotations",
        "captions_train2017.json",
    )
    if os.path.exists(ann) and args.steps is None:
        with open(ann) as f:
            n = len(json.load(f)["images"])
        steps = math.ceil(n / cfg.micro_batch_size)
        cfg = dataclasses.replace(
            cfg, schedule=dataclasses.replace(cfg.schedule, max_steps=steps)
        )
    return run(cfg, args, overrides=overrides)


if __name__ == "__main__":
    main()
