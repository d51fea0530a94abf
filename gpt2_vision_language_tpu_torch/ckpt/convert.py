"""Weights between the JAX package, reference checkpoints and the port.

``gpt2_from_jax_params`` turns the JAX parameter pytree (numpy arrays,
layers stacked on a leading axis, Linear weights stored (in, out)) into
the port's state dict: the layer axis un-stacked, weights transposed to
torch's (out, in), ``lm_head.weight`` tied to ``transformer.wte.weight``.
It agrees key for key and value for value with
gpt2_vision_language_tpu/ckpt/torch_export.py gpt2_to_torch_state_dict, and
carries the gated cross-attention leaves. ``bridge_from_jax_params`` does the
same for the linear and Q-Former bridges (the Q-Former's three projection
matrices packed as torch ``nn.MultiheadAttention`` packs them) and
``caption_from_jax_params`` for the pair.

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
# the gated cross-attention variant's block leaves (ckpt/torch_import.py:92-108)
_XATTN_BLOCK_LEAVES = (
    ("lnx", "scale", "ln_x.weight", False),
    ("lnx", "bias", "ln_x.bias", False),
    ("xattn", "wq", "xattn.q_proj.weight", True),
    ("xattn", "bq", "xattn.q_proj.bias", False),
    ("xattn", "wkv", "xattn.kv_proj.weight", True),
    ("xattn", "bkv", "xattn.kv_proj.bias", False),
    ("xattn", "wo", "xattn.c_proj.weight", True),
    ("xattn", "bo", "xattn.c_proj.bias", False),
)
# Q-Former layer leaves that are not attention: JAX (group, name) -> name
_QFORMER_LEAVES = (
    ("ln1", "scale", "ln1.weight", False), ("ln1", "bias", "ln1.bias", False),
    ("ln2_q", "scale", "ln2_q.weight", False), ("ln2_q", "bias", "ln2_q.bias", False),
    ("ln2_v", "scale", "ln2_v.weight", False), ("ln2_v", "bias", "ln2_v.bias", False),
    ("ln3", "scale", "ln3.weight", False), ("ln3", "bias", "ln3.bias", False),
    ("mlp", "wfc", "mlp.0.weight", True), ("mlp", "bfc", "mlp.0.bias", False),
    ("mlp", "wproj", "mlp.2.weight", True), ("mlp", "bproj", "mlp.2.bias", False),
)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _is_placeholder(a) -> bool:
    """The JAX AdamW state holds a 0-d placeholder for a frozen leaf's moments
    (train/optimizer.py adamw_init): such a leaf has no counterpart here."""
    return np.ndim(a) == 0


def gpt2_from_jax_params(params_np, cfg: GPTConfig) -> Dict[str, torch.Tensor]:
    """The port's fp32 state dict from a JAX GPT-2 parameter pytree, the
    gated cross-attention leaves (``lnx``, ``xattn``, ``gate``, ``vis_proj``)
    included when ``cfg.cross_attention``. A tree of AdamW moments goes
    through the same mapping; its 0-d placeholders (frozen leaves) are left
    out."""
    sd = {}

    def put(name, a, transpose=False):
        if not _is_placeholder(a):
            a = np.asarray(a)
            sd[name] = _t(a.T if transpose else a)

    if not _is_placeholder(params_np["wte"]):
        wte = _t(params_np["wte"])[: cfg.padded_vocab_size]
        sd["transformer.wte.weight"] = sd["lm_head.weight"] = wte
    put("transformer.wpe.weight", params_np["wpe"])
    blocks = params_np["blocks"]
    leaves = _BLOCK_LEAVES + (_XATTN_BLOCK_LEAVES if cfg.cross_attention else ())
    for i in range(cfg.n_layer):
        for group, leaf, name, transpose in leaves:
            a = blocks[group][leaf]
            put(f"transformer.h.{i}.{name}", a if _is_placeholder(a) else a[i], transpose)
        if cfg.cross_attention and not _is_placeholder(blocks["gate"]):
            put(f"transformer.h.{i}.cross_gate", np.asarray(blocks["gate"])[i].reshape(1))
    put("transformer.ln_f.weight", params_np["lnf"]["scale"])
    put("transformer.ln_f.bias", params_np["lnf"]["bias"])
    if cfg.cross_attention:
        put("transformer.vis_proj.z_proj.weight", params_np["vis_proj"]["w"], True)
        put("transformer.vis_proj.z_proj.bias", params_np["vis_proj"]["b"])
    return sd


def bridge_from_jax_params(params_np, bridge_cfg) -> Dict[str, torch.Tensor]:
    """The port's fp32 state dict of a bridge (models/bridges.py) from the JAX
    bridge pytree: Linear weights (in, out) -> (out, in); for the Q-Former the
    layer axis un-stacked and each attention's separate wq / wk / wv packed
    into torch's ``in_proj_weight`` (3D, D) rows [q; k; v] and ``in_proj_bias``
    (the inverse of ckpt/torch_import.py qformer_bridge_from_torch)."""
    sd = {"vis_proj.weight": _t(np.asarray(params_np["vis_proj"]["w"]).T),
          "vis_proj.bias": _t(params_np["vis_proj"]["b"])}
    if bridge_cfg.kind == "linear":
        return sd
    if bridge_cfg.kind != "qformer":
        raise ValueError(f"no bridge parameters for kind {bridge_cfg.kind!r}")
    sd["query_tokens"] = _t(params_np["query_tokens"])
    layers = params_np["layers"]
    n_layers = np.asarray(layers["ln1"]["scale"]).shape[0]
    for i in range(n_layers):
        pre = f"layers.{i}."
        for group, leaf, name, transpose in _QFORMER_LEAVES:
            a = np.asarray(layers[group][leaf][i])
            sd[pre + name] = _t(a.T if transpose else a)
        for attn in ("self_attn", "cross_attn"):
            p = {k: np.asarray(v[i]) for k, v in layers[attn].items()}
            sd[f"{pre}{attn}.in_proj_weight"] = _t(
                np.concatenate([p["wq"].T, p["wk"].T, p["wv"].T], axis=0))
            sd[f"{pre}{attn}.in_proj_bias"] = _t(np.concatenate([p["bq"], p["bk"], p["bv"]]))
            sd[f"{pre}{attn}.out_proj.weight"] = _t(p["wo"].T)
            sd[f"{pre}{attn}.out_proj.bias"] = _t(p["bo"])
    return sd


def caption_from_jax_params(params_np, cfg: GPTConfig, bridge_cfg) -> Dict[str, torch.Tensor]:
    """The state dict of models/caption.CaptionModel from the JAX fine-tune
    tree {"gpt": ..., "bridge": ...}: ``gpt.*`` and ``bridge.*``."""
    sd = {f"gpt.{k}": v for k, v in gpt2_from_jax_params(params_np["gpt"], cfg).items()}
    sd.update({f"bridge.{k}": v
               for k, v in bridge_from_jax_params(params_np["bridge"], bridge_cfg).items()})
    return sd


def opt_state_from_jax(opt_state_np, cfg: GPTConfig, bridge_cfg=None) -> dict:
    """The port's AdamW state {"m", "v", "step"} from the JAX one: moments
    keyed by the state-dict names of ``models.gpt2.named_params`` (the tied
    weight once, as transformer.wte.weight). With ``bridge_cfg`` the trees are
    the prefix fine-tunes' {"gpt", "bridge"}: the frozen decoder's placeholder
    moments are left out and the bridge's come back under ``bridge.*``."""
    def moments(tree):
        if bridge_cfg is None:
            sd = gpt2_from_jax_params(tree, cfg)
            sd.pop("lm_head.weight", None)
            return sd
        sd = {f"gpt.{k}": v for k, v in gpt2_from_jax_params(tree["gpt"], cfg).items()
              if k != "lm_head.weight"}
        sd.update({f"bridge.{k}": v
                   for k, v in bridge_from_jax_params(tree["bridge"], bridge_cfg).items()})
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
