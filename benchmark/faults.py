"""Faults planted in the program, for the checks that ``correct`` must fail.

Each is a context manager that swaps a function of the program's modules for
a broken one and puts it back on exit; the driver reaches the program through
those modules' attributes, so the run in between takes the broken path:

  * ``unchanged``: the optimizer step returns the state as it was;
  * ``half_batch``: each step gets the first half of its micro-batches, and
    the mean is taken over those;
  * ``double_update``: each step moves the parameters and moments twice.

The exchange between chips has no place on one chip. A training step
produces no tokens or answers to alter: what it produces is the update,
which the three above break.
"""

from __future__ import annotations

import contextlib

from gpt2_vision_language_tpu_torch.train import pretrain as port_pretrain
from gpt2_vision_language_tpu_torch.train import step as port_step

FAULTS = ("unchanged", "half_batch", "double_update")


@contextlib.contextmanager
def _swap(module, name, fn):
    orig = getattr(module, name)
    setattr(module, name, fn(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def _unchanged(orig):
    def adamw_update(*args, **kwargs):
        return None
    return adamw_update


def _double(orig):
    def adamw_update(*args, **kwargs):
        orig(*args, **kwargs)
        return orig(*args, **kwargs)
    return adamw_update


def _half(orig):
    def split_rows_on_device(rows):
        return {k: v[: max(1, v.shape[0] // 2)] for k, v in orig(rows).items()}
    return split_rows_on_device


def plant(name: str):
    """The context manager of the fault ``name``."""
    if name == "unchanged":
        return _swap(port_step, "adamw_update", _unchanged)
    if name == "double_update":
        return _swap(port_step, "adamw_update", _double)
    if name == "half_batch":
        return _swap(port_pretrain, "split_rows_on_device", _half)
    raise ValueError(f"unknown fault {name!r}; one of {FAULTS}")
