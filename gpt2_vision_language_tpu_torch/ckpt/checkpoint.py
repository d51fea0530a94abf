"""Atomic rolling checkpoints with the last/best/final triad and auto-resume.

Counterpart of gpt2_vision_language_tpu/ckpt/checkpoint.py, with the
reference's semantics (train_gpt2.py:307-329,363-391,494-508):

  * each write goes to a temp file in the same directory and then
    ``os.replace``, so a checkpoint on disk is always whole;
  * ``model_last`` every ``save_every`` steps and at the last step,
    ``model_best`` whenever the val loss improves, ``model_final`` at the end;
  * ``maybe_resume`` returns the params, the optimizer state, the step to
    run next and re-seeds ``best_val`` from ``model_best``.

The format is the port's own: one ``torch.save`` file holding the model's
state dict, the AdamW state {"m", "v", "step"} and a metadata dict. Every
storage of the memory recipes goes through as it is: bf16 params, bf16
moments and the 8-bit moments' {"q", "s"} dicts keyed by JAX leaf path
(train/optimizer.py); the trainer converts a restored state to the
configured storage (``convert_moments``). Writes are synchronous. ``load_jax_checkpoint`` reads the JAX package's ``.npz``
(its ckpt/checkpoint.py:97-116) without jax or ``ml_dtypes``: a nested dict
of numpy arrays, which ckpt/convert.py turns into the port's state dicts.

Every metadata dict carries ``next_step``, the step a resumed run starts
at. A rolling save happens at the top of step s, before its update, so its
next step is s; ``model_final`` records the step after the last one run.
``maybe_resume`` takes whichever of ``model_last`` and ``model_final`` is
further along, so a run extended with a larger ``--steps`` continues where
the previous one ended.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Optional, Tuple

import numpy as np
import torch

# the JAX package's key suffix for a bf16 leaf stored as its uint16 bits
_BF16_TAG = "::bfloat16"


def save_checkpoint(path: str, tree: dict, meta: Optional[dict] = None) -> None:
    """Atomically write ``tree`` (tensors, dicts, numbers) and ``meta``."""
    directory = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save({**tree, "meta": dict(meta or {})}, f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_checkpoint(path: str, map_location="cpu") -> Tuple[dict, dict]:
    """Load a checkpoint -> (tree, meta); tensors are memory-mapped until
    used."""
    ckpt = torch.load(path, map_location=map_location, mmap=True, weights_only=True)
    meta = ckpt.pop("meta", {})
    return ckpt, meta


def load_jax_checkpoint(path: str) -> Tuple[dict, dict]:
    """Read a JAX-package ``.npz`` checkpoint -> (nested dict of numpy arrays,
    meta). Keys are "/"-joined paths, ``__meta__`` is JSON bytes, and a key
    ending in ``::bfloat16`` holds the leaf's uint16 bits, widened here
    exactly to fp32 (the bits shifted into the high half of a float32)."""
    tree: dict = {}
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(z["__meta__"].tobytes().decode()) if "__meta__" in z.files else {}
        for key in z.files:
            if key == "__meta__":
                continue
            val = z[key]
            if key.endswith(_BF16_TAG):
                if val.dtype != np.uint16:
                    raise ValueError(f"{path}: {key!r} holds {val.dtype}, not bf16 bits")
                key = key[: -len(_BF16_TAG)]
                val = (val.astype(np.uint32) << 16).view(np.float32)
            node = tree
            *parents, leaf = key.split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = val
    return tree, meta


class CheckpointManager:
    """last/best/final triad with the reference's cadence and atomicity."""

    LAST = "model_last.pt"
    BEST = "model_best.pt"
    FINAL = "model_final.pt"

    def __init__(self, ckpt_dir: str, save_every: int = 2500, enabled: bool = True):
        """enabled=False turns every save and the resume into no-ops."""
        self.dir = ckpt_dir
        self.save_every = save_every
        self.best_val = float("inf")
        self.enabled = enabled
        if enabled:
            os.makedirs(ckpt_dir, exist_ok=True)

    @property
    def last_path(self) -> str:
        return os.path.join(self.dir, self.LAST)

    @property
    def best_path(self) -> str:
        return os.path.join(self.dir, self.BEST)

    @property
    def final_path(self) -> str:
        return os.path.join(self.dir, self.FINAL)

    def maybe_resume(self, map_location="cpu") -> Optional[Tuple[dict, dict]]:
        """(tree, meta) of the checkpoint furthest along among model_last
        and model_final, or None; re-seeds best_val from model_best."""
        if not self.enabled:
            return None
        if os.path.isfile(self.best_path):
            _, best_meta = load_checkpoint(self.best_path)
            if best_meta.get("val_loss") is not None:
                self.best_val = float(best_meta["val_loss"])
        found = [load_checkpoint(p, map_location) for p in (self.last_path, self.final_path)
                 if os.path.isfile(p)]
        if not found:
            return None
        return max(found, key=lambda tm: tm[1]["next_step"])

    @staticmethod
    def state_tree(model: torch.nn.Module, opt_state: dict) -> dict:
        return {"model": model.state_dict(), "opt_state": opt_state}

    def save_step(self, step: int, model, opt_state, val_loss: float, *,
                  last_step: bool) -> None:
        """Rolling + best writes at the top of step ``step``
        (train_gpt2.py:363-391)."""
        if not self.enabled:
            return
        meta = {"step": step, "next_step": step, "val_loss": float(val_loss)}
        rolling = (self.save_every > 0 and step > 0
                   and (step % self.save_every == 0 or last_step))
        best = val_loss < self.best_val
        tree = self.state_tree(model, opt_state)
        if rolling:
            save_checkpoint(self.last_path, tree, meta)
        if best:
            self.best_val = float(val_loss)
            save_checkpoint(self.best_path, tree, meta)

    def save_final(self, step: int, model, opt_state, val_loss=None, *,
                   next_step: int) -> None:
        """``model_final`` after the last step run, ``step``; ``next_step``
        is where a resumed run starts."""
        if not self.enabled:
            return
        meta = {"step": step, "next_step": next_step,
                "val_loss": None if val_loss is None else float(val_loss)}
        save_checkpoint(self.final_path, self.state_tree(model, opt_state), meta)
