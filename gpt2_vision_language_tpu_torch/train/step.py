"""Train and eval steps with gradient accumulation over micro-batches.

Counterpart of gpt2_vision_language_tpu/train/step.py. ``make_train_step``
(:90-410): a Python loop over the micro-batches of one optimizer step, each
``loss.backward()`` accumulating into the fp32 ``.grad`` of the params, the
1/accum mean folded into AdamW's clip scale, the LR from the cosine
schedule, and a NaN guard that skips the update when the loss or the grad
norm is non-finite, checked once per step on the host (the semantics of
the JAX split path, :508-523). Params and moments are updated in place.
The TPU-only mechanisms (split_accum, sync_every, io_formats, donation) are
not carried; the bf16 stochastic-rounding accumulator and the layerwise
backward wait for ROADMAP Queue 1 item 11.

``make_eval_step`` (:707-729): the mean loss over a batch of micro-batches,
as the val-loss loop runs it (train_gpt2.py:341-350). It runs without
autograd, so ``models.gpt2.loss`` takes the scoring path (flash and fused
CE kernels on CUDA under the bf16 policy).
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from ..core.config import OptimizerConfig, ScheduleConfig
from ..models.gpt2 import named_params
from .optimizer import adamw_update, freeze, global_norm
from .schedule import cosine_warmup_lr


def _micro(batch, i: int):
    """Micro-batch i of a batch whose tensors carry a leading steps axis
    (a tensor, or a dict / tuple / list of them)."""
    if isinstance(batch, torch.Tensor):
        return batch[i]
    if isinstance(batch, dict):
        return {k: _micro(v, i) for k, v in batch.items()}
    return type(batch)(_micro(v, i) for v in batch)


def _steps(batch) -> int:
    while not isinstance(batch, torch.Tensor):
        batch = next(iter(batch.values())) if isinstance(batch, dict) else batch[0]
    return batch.shape[0]


def make_train_step(loss_fn: Callable, opt_cfg: OptimizerConfig,
                    sched_cfg: ScheduleConfig, *, decay_mask, trainable_mask=None,
                    use_fused_adamw: bool = True, nan_guard: bool = True):
    """Build ``step(model, opt_state, batch, step_idx) -> metrics``.

    loss_fn(model, micro) -> scalar loss tensor; ``batch`` carries a leading
    micro-batch axis (a tensor or a dict / tuple / list of them). The model's
    params and ``opt_state`` are updated in place. metrics: {"loss", "lr",
    "grad_norm"} as Python floats (the reference's log line,
    train_gpt2.py:485); with nan_guard and a non-finite loss or norm the
    update is skipped and the state is left as it was. The update goes
    through the AdamW kernel on CUDA; ``use_fused_adamw=False`` runs the
    plain per-leaf version instead (the path the kernel is compared with)."""

    def step(model, opt_state, batch, step_idx):
        if trainable_mask is not None:
            freeze(model, trainable_mask)
        params = named_params(model)
        tmask = trainable_mask or {n: True for n in params}
        for p in params.values():
            p.grad = None
        accum = _steps(batch)
        lsum = None
        for i in range(accum):
            loss = loss_fn(model, _micro(batch, i))
            loss.backward()
            l = loss.detach().float()
            lsum = l if lsum is None else lsum + l
        inv_accum = 1.0 / accum
        loss = lsum * inv_accum
        lr = cosine_warmup_lr(step_idx, sched_cfg)
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items() if tmask[n]}
        norm = global_norm(grads) * inv_accum
        loss_h, norm_h = torch.stack([loss, norm]).tolist()  # the one host read
        metrics = {"loss": loss_h, "lr": lr, "grad_norm": norm_h}
        if nan_guard and not (math.isfinite(loss_h) and math.isfinite(norm_h)):
            return metrics
        adamw_update(params, grads, opt_state, lr, opt_cfg, norm=norm, decay_mask=decay_mask,
                     trainable_mask=tmask, use_fused=use_fused_adamw, grad_scale=inv_accum)
        return metrics

    return step


def make_eval_step(loss_fn: Callable):
    """step(model, batch, extra=None) -> mean of loss_fn(model, micro) over
    the leading axis of ``batch``, an fp32 scalar tensor; with ``extra``,
    loss_fn(model, micro, extra)."""

    @torch.no_grad()
    def step(model, batch, extra=None):
        n = _steps(batch)
        lsum = None
        for i in range(n):
            micro = _micro(batch, i)
            l = loss_fn(model, micro) if extra is None else loss_fn(model, micro, extra)
            l = l.float()
            lsum = l if lsum is None else lsum + l
        return lsum / n

    return step
