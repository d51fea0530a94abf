"""Evaluation step.

Counterpart of gpt2_vision_language_tpu/train/step.py:707-729
``make_eval_step``: the mean loss over a batch of micro-batches, as the
val-loss loop runs it (train_gpt2.py:341-350). It runs without autograd,
so ``models.gpt2.loss`` takes the scoring path (flash and fused CE kernels
on CUDA under the bf16 policy). The train step is not ported yet.
"""

from __future__ import annotations

from typing import Callable

import torch


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
