"""Sizes of the port's trees: name-keyed parameter dicts, AdamW states and
checkpoint trees.

Counterpart of gpt2_vision_language_tpu/utils/trees.py. A tree is a tensor or
a dict / list / tuple of trees; an 8-bit moment ({"q": codes, "s": scales},
train/optimizer.py) is a dict like any other, so its codes and its scales both
count. Leaves that are not tensors (the optimizer's ``step``, a Python int)
count nothing.
"""

from __future__ import annotations

import torch


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def tree_size(tree) -> int:
    """Total element count over all tensor leaves."""
    return sum(t.numel() for t in _leaves(tree))


def tree_bytes(tree) -> int:
    """Total bytes over all tensor leaves, each at its own dtype."""
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def fmt_count(n: int) -> str:
    for unit, div in (("B", 1e9), ("M", 1e6), ("K", 1e3)):
        if n >= div:
            return f"{n / div:.2f}{unit}"
    return str(n)
