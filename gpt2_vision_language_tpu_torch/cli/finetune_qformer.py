"""CLI: Q-Former bridge COCO fine-tune (reference: source/gpt2_q_former/train.py).

    python -m gpt2_vision_language_tpu_torch.cli.finetune_qformer --init-ckpt ... [--synthetic]

Counterpart of gpt2_vision_language_tpu/cli/finetune_qformer.py; runs on the
first CUDA device unless ``--device cpu``.
"""

from __future__ import annotations

from ..core.config import finetune_qformer_preset
from ._finetune_common import make_main

main = make_main(finetune_qformer_preset, __doc__)


if __name__ == "__main__":
    main()
