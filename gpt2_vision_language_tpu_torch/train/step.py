"""Train and eval steps with gradient accumulation over micro-batches.

Counterpart of gpt2_vision_language_tpu/train/step.py. ``make_train_step``
(:90-410): a Python loop over the micro-batches of one optimizer step, the
1/accum mean folded into AdamW's clip scale, the LR from the cosine
schedule, and a NaN guard that skips the update when the loss or the grad
norm is non-finite, checked once per step on the host (the semantics of
the JAX split path, :508-523). Params and moments are updated in place.
The TPU-only mechanisms (split_accum, sync_every, io_formats, donation) are
not carried.

Where the gradients are summed: with fp32 params and fp32 accumulators each
``loss.backward()`` accumulates into the params' fp32 ``.grad``. Otherwise
the step keeps explicit accumulators, as the JAX step does (``accumulate``
:191-257): with ``grad_accum_dtype="bfloat16"`` bf16 ones, each fold an fp32
sum rounded back by ``stochastic_round_bf16``; with bf16 params (whose
``.grad`` torch would sum by round-to-nearest in bf16) fp32 ones. Each
micro-batch's grads are folded in and dropped. ``layerwise_loss_grad``
(``models.gpt2.loss_grad_layerwise``) folds them layer by layer as it forms
them. The stochastic rounding's bits come from a ``torch.Generator`` on the
params' device seeded per (step, micro-batch, parameter), so a resumed run
draws what an uninterrupted one would.

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

SR_SALT = 0x5EED


def stochastic_round_bf16(x32: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """fp32 -> bf16 with unbiased stochastic rounding (JAX :34): 16 uniform
    random bits added under the kept mantissa, then truncation, so that
    E[round(x)] = x (sign-magnitude: symmetric for negatives). Values
    already in bf16 come back exactly. The add can carry a NaN's small
    payload into the exponent: callers treat non-finite as non-finite, never
    rely on NaN surviving. ``generator`` lives on x32's device."""
    bits = x32.float().contiguous().view(torch.int32)
    rnd = torch.randint(0, 1 << 16, x32.shape, dtype=torch.int32, device=x32.device,
                        generator=generator)
    # int32 addition wraps as the JAX uint32 addition does; -65536 is 0xFFFF0000
    out = (bits + rnd) & -65536
    return out.view(torch.float32).to(torch.bfloat16)


def sr_seed(step_idx: int, micro: int, leaf: int) -> int:
    """The seed of one stochastic rounding: one per (step, micro-batch,
    parameter), so no two roundings share bits and a resumed run draws the
    same ones."""
    m = 1_000_003
    return ((((SR_SALT * m + step_idx) * m + micro) * m) + leaf) % (1 << 63)


class GradAccumulators:
    """Explicit gradient accumulators (``make_train_step``): name ->
    zeros of ``dtype`` for the trainable params; ``add(name, g)`` folds one
    grad in, in fp32, or, for bf16 accumulators, as the stochastically
    rounded fp32 sum. ``micro`` and ``step_idx`` pick the rounding's
    seeds."""

    def __init__(self, params: dict, tmask: dict, dtype: torch.dtype, step_idx: int):
        self.sums = {n: torch.zeros_like(p, dtype=dtype) for n, p in params.items() if tmask[n]}
        self.index = {n: i for i, n in enumerate(params)}
        self.sr = dtype == torch.bfloat16
        self.step_idx, self.micro = step_idx, 0
        self.gen = None
        if self.sr and self.sums:
            self.gen = torch.Generator(next(iter(self.sums.values())).device)

    def add(self, name: str, g: torch.Tensor) -> None:
        a = self.sums[name]
        if not self.sr:
            a.add_(g)
            return
        self.gen.manual_seed(sr_seed(self.step_idx, self.micro, self.index[name]))
        a.copy_(stochastic_round_bf16(a.float() + g.float(), self.gen))


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
                    use_fused_adamw: bool = True, nan_guard: bool = True,
                    grad_accum_dtype=None, layerwise_loss_grad: Callable = None):
    """Build ``step(model, opt_state, batch, step_idx, extra=None) -> metrics``.

    loss_fn(model, micro) -> scalar loss tensor, or loss_fn(model, micro,
    extra) when the step is given ``extra`` (the fine-tunes' device-resident
    feature bank, as make_eval_step takes it); ``batch`` carries a leading
    micro-batch axis (a tensor or a dict / tuple / list of them). With a
    ``trainable_mask`` the frozen leaves have requires_grad off: they get no
    ``.grad``, stay out of the norm and out of the AdamW kernel's leaf table. The model's
    params and ``opt_state`` are updated in place. metrics: {"loss", "lr",
    "grad_norm"} as Python floats (the reference's log line,
    train_gpt2.py:485); with nan_guard and a non-finite loss or norm the
    update is skipped and the state is left as it was. The update goes
    through the AdamW kernel on CUDA (the leaves it takes, train/optimizer.py);
    ``use_fused_adamw=False`` runs the plain per-leaf version instead (the
    path the kernel is compared with).

    grad_accum_dtype: None / "float32", or "bfloat16" for stochastically
    rounded bf16 accumulators. layerwise_loss_grad(model, micro, acc) ->
    loss: forms one micro-batch's loss and folds its grads into ``acc``
    (``acc.add(name, grad)``) itself, in place of loss_fn's backward;
    every param trainable."""
    accum_dt = torch.bfloat16 if grad_accum_dtype in ("bfloat16", torch.bfloat16) else torch.float32
    if layerwise_loss_grad is not None and trainable_mask is not None:
        raise ValueError("layerwise_loss_grad accumulates every parameter: no trainable_mask")

    def step(model, opt_state, batch, step_idx, extra=None):
        if trainable_mask is not None:
            freeze(model, trainable_mask)
        params = named_params(model)
        tmask = trainable_mask or {n: True for n in params}
        for p in params.values():
            p.grad = None
        explicit = (layerwise_loss_grad is not None or accum_dt != torch.float32
                    or any(p.dtype != torch.float32 for p in params.values()))
        acc = GradAccumulators(params, tmask, accum_dt, step_idx) if explicit else None
        accum = _steps(batch)
        lsum = None
        for i in range(accum):
            micro = _micro(batch, i)
            if acc is not None:
                acc.micro = i
            if layerwise_loss_grad is not None:
                if extra is not None:
                    raise ValueError("layerwise_loss_grad takes no `extra`")
                loss = layerwise_loss_grad(model, micro, acc)
            else:
                loss = loss_fn(model, micro) if extra is None else loss_fn(model, micro, extra)
                loss.backward()
                if acc is not None:  # fold this micro-batch's grads in, then drop them
                    for n, p in params.items():
                        if p.grad is not None:
                            acc.add(n, p.grad)
                            p.grad = None
            l = loss.detach().float()
            lsum = l if lsum is None else lsum + l
        inv_accum = 1.0 / accum
        loss = lsum * inv_accum
        lr = cosine_warmup_lr(step_idx, sched_cfg)
        if acc is not None:
            grads = acc.sums
        else:
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
