"""AdamW with decay/no-decay groups, global-norm clipping and freezing.

Counterpart of gpt2_vision_language_tpu/train/optimizer.py (fp32 moments):
weight decay 0.1 on the weights only (the decay mask), betas (0.9, 0.95),
eps 1e-8, decoupled decay applied before the Adam step (torch AdamW order),
bias corrections from ``step + 1``, and grads scaled by
min(1, clip / (norm + 1e-6)) with the global norm over all trainable grads.
Frozen params are left out of the update and of the norm by a trainable
mask.

Parameters, grads, moments and masks are dicts keyed by state-dict name
(``models.gpt2.named_params``: the tied weight once). Unlike the JAX
version, ``adamw_update`` updates params and moments in place, which keeps
one copy of each in device memory, and takes the global norm from its
caller (the train step computes it once for its NaN guard). The update is
``ops/fused_adamw.fused_adamw``: one launch of the CUDA kernel over every
leaf for CUDA tensors, the plain version leaf by leaf for CPU tensors.
``use_fused=False`` runs ``adamw_reference`` leaf by leaf on any device,
the plain path the kernel is compared with. The bf16 and 8-bit moments are
not ported yet (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..core.config import OptimizerConfig
from ..ops.fused_adamw import adamw_reference, fused_adamw


def adamw_init(params: Dict[str, torch.Tensor], trainable_mask=None) -> dict:
    """Zero fp32 moments keyed by name; frozen leaves get none."""
    def zeros():
        return {n: torch.zeros_like(p, dtype=torch.float32)
                for n, p in params.items()
                if trainable_mask is None or trainable_mask[n]}

    return {"m": zeros(), "v": zeros(), "step": 0}


def global_norm(grads: Dict[str, torch.Tensor], mask=None) -> torch.Tensor:
    """sqrt of the sum of squares of the (masked-in) grads, fp32, on their
    device."""
    sq = [g.float().square().sum() for n, g in grads.items()
          if mask is None or mask[n]]
    return torch.stack(sq).sum().sqrt()


def adamw_update(
    params: Dict[str, torch.Tensor],
    grads: Dict[str, torch.Tensor],
    state: dict,
    lr: float,
    cfg: OptimizerConfig,
    *,
    norm: torch.Tensor,
    decay_mask,
    trainable_mask=None,
    use_fused: bool = True,
    grad_scale: Optional[float] = None,
) -> None:
    """One optimizer step, in place on params and state.

    norm: the pre-clip global norm of the trainable grads, already scaled
    by grad_scale, an fp32 scalar on the params' device.
    grad_scale: a factor applied to every grad (the grad-accumulation
    1/accum mean), folded into the clip scale as the JAX version does."""
    if trainable_mask is None:
        trainable_mask = {n: True for n in params}
    names = [n for n in params if trainable_mask[n]]
    step = state["step"] + 1
    t = np.float32(step)
    bc1 = np.float32(1.0) - np.float32(cfg.beta1) ** t
    bc2 = np.float32(1.0) - np.float32(cfg.beta2) ** t

    clip_scale = torch.clamp(cfg.grad_clip / (norm + 1e-6), max=1.0)
    if grad_scale is not None:
        clip_scale = clip_scale * grad_scale

    device = params[names[0]].device
    scalars = torch.tensor(
        [lr, cfg.beta1, cfg.beta2, cfg.eps, 0.0, bc1, bc2], dtype=torch.float32
    ).to(device)
    scalars[4] = clip_scale
    leaves = [(params[n], grads[n], state["m"][n], state["v"][n]) for n in names]
    wds = [cfg.weight_decay if decay_mask[n] else 0.0 for n in names]
    with torch.no_grad():
        if use_fused:
            fused_adamw(leaves, scalars, wds)
        else:
            for (p, g, m, v), wd in zip(leaves, wds):
                adamw_reference(p, g, m, v, scalars, wd=wd)
    state["step"] = step


def freeze(model: torch.nn.Module, trainable_mask) -> None:
    """requires_grad_(False) on the frozen params (the reference's freeze,
    gpt2_linear/model.py:161-164): they get no gradient and no backward
    work."""
    for n, p in model.named_parameters():
        if n in trainable_mask:
            p.requires_grad_(bool(trainable_mask[n]))
