"""Weights between the JAX package, reference checkpoints and the port.

``gpt2_from_jax_params`` turns the JAX parameter pytree (numpy arrays,
layers stacked on a leading axis, Linear weights stored (in, out)) into
the port's state dict: the layer axis un-stacked, weights transposed to
torch's (out, in), ``lm_head.weight`` tied to ``transformer.wte.weight``.
It agrees key for key and value for value with
gpt2_vision_language_tpu/ckpt/torch_export.py gpt2_to_torch_state_dict.

``opt_state_from_jax`` maps the JAX AdamW state (fp32 ``m``/``v``
pytrees of the params' structure, and ``step``) to the port's
``train/optimizer`` state by the same rule, so both start from the same
params and moments.

``load_reference_checkpoint`` reads a reference-format ``.pt``
(``{"model": state_dict, ...}``, train_gpt2.py:363-391) into a state dict
that ``GPT2.load_state_dict`` takes, as ckpt/torch_import.py does for the
JAX package.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..core.config import GPTConfig

# JAX leaf (block group, name) -> reference name and whether it is a Linear
# weight that torch stores transposed
_BLOCK_LEAVES = (
    ("ln1", "scale", "ln_1.weight", False),
    ("ln1", "bias", "ln_1.bias", False),
    ("attn", "wqkv", "attn.c_attn.weight", True),
    ("attn", "bqkv", "attn.c_attn.bias", False),
    ("attn", "wo", "attn.c_proj.weight", True),
    ("attn", "bo", "attn.c_proj.bias", False),
    ("ln2", "scale", "ln_2.weight", False),
    ("ln2", "bias", "ln_2.bias", False),
    ("mlp", "wfc", "mlp.c_fc.weight", True),
    ("mlp", "bfc", "mlp.c_fc.bias", False),
    ("mlp", "wproj", "mlp.c_proj.weight", True),
    ("mlp", "bproj", "mlp.c_proj.bias", False),
)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def gpt2_from_jax_params(params_np, cfg: GPTConfig) -> Dict[str, torch.Tensor]:
    """The port's fp32 state dict from a JAX GPT-2 parameter pytree."""
    if cfg.cross_attention:
        raise NotImplementedError(
            "the gated cross-attention decoder is not ported yet "
            "(ROADMAP Queue 1 item 6)"
        )
    wte = _t(params_np["wte"])[: cfg.padded_vocab_size]
    sd = {"transformer.wte.weight": wte, "lm_head.weight": wte,
          "transformer.wpe.weight": _t(params_np["wpe"])}
    blocks = params_np["blocks"]
    for i in range(cfg.n_layer):
        for group, leaf, name, transpose in _BLOCK_LEAVES:
            a = np.asarray(blocks[group][leaf][i])
            sd[f"transformer.h.{i}.{name}"] = _t(a.T if transpose else a)
    sd["transformer.ln_f.weight"] = _t(params_np["lnf"]["scale"])
    sd["transformer.ln_f.bias"] = _t(params_np["lnf"]["bias"])
    return sd


def opt_state_from_jax(opt_state_np, cfg: GPTConfig) -> dict:
    """The port's AdamW state {"m", "v", "step"} from the JAX one: moments
    keyed by the state-dict names of ``models.gpt2.named_params`` (the tied
    weight once, as transformer.wte.weight)."""
    def moments(tree):
        sd = gpt2_from_jax_params(tree, cfg)
        del sd["lm_head.weight"]
        return sd

    return {"m": moments(opt_state_np["m"]), "v": moments(opt_state_np["v"]),
            "step": int(np.asarray(opt_state_np["step"]))}


def load_reference_checkpoint(path: str, cfg: GPTConfig):
    """Read a reference ``.pt`` -> (state dict for GPT2, meta). Drops the
    causal-mask buffers some reference versions register as ``...attn.bias``
    and zero-pads an unpadded vocab to ``cfg.padded_vocab_size`` rows."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd: Mapping = ckpt["model"] if isinstance(ckpt, dict) and "model" in ckpt else ckpt
    meta = ({k: v for k, v in ckpt.items() if k != "model"}
            if isinstance(ckpt, dict) else {})
    sd = {k: v.float() for k, v in sd.items()
          if k.split(".")[-2:] != ["attn", "bias"]}
    wte = sd["transformer.wte.weight"]
    pad = cfg.padded_vocab_size - wte.shape[0]
    if pad > 0:
        wte = torch.cat([wte, wte.new_zeros(pad, wte.shape[1])])
    sd["transformer.wte.weight"] = wte
    sd["lm_head.weight"] = wte
    return sd, meta
