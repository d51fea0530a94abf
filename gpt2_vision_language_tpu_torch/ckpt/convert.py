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
``caption_from_jax_params`` for the pair. ``clip_from_jax_params`` turns the
JAX CLIP ViT tree (models/clip_vit.py) into the state dict of the port's
``CLIPVisionTower``, which has HF CLIPVisionModel's names: the fused QKV
split into q/k/v projections, the patch matmul's weight back into the
conv's (width, 3, p, p) shape.

``opt_state_from_jax`` maps the JAX AdamW state (fp32 ``m``/``v``
pytrees of the params' structure, and ``step``) to the port's
``train/optimizer`` state by the same rule, so both start from the same
params and moments.

``jax_leaf_name`` gives the JAX leaf name of a port parameter (the decode
cast's rule is by that name), and ``check_jax_paths`` holds a JAX tree to the
leaves these converters read. The readers of files from outside the port
(reference and HF ``.pt``/``.bin``/``.safetensors``) are in
``ckpt/torch_import.py``, the JAX ``.npz`` reader in ``ckpt/checkpoint.py``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..core.config import CLIPConfig, GPTConfig

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


# port parameter names outside the layer tables -> the JAX leaf's name
_TOP_LEAVES = {
    "transformer.wte.weight": "wte", "lm_head.weight": "wte",
    "transformer.wpe.weight": "wpe",
    "transformer.ln_f.weight": "scale", "transformer.ln_f.bias": "bias",
    "transformer.vis_proj.z_proj.weight": "w", "transformer.vis_proj.z_proj.bias": "b",
    # the bridges (models/bridges.py), bare or under CaptionModel's bridge.*
    "vis_proj.weight": "w", "vis_proj.bias": "b", "query_tokens": "query_tokens",
}
_GPT_LAYER_LEAVES = {**{name: leaf for _, leaf, name, _ in _BLOCK_LEAVES + _XATTN_BLOCK_LEAVES},
                     "cross_gate": "gate"}
# every parameter of a Q-Former layer; in_proj_weight packs the JAX leaves wq,
# wk and wv (in_proj_bias bq, bk and bv)
_QFORMER_LAYER_LEAVES = {
    **{name: leaf for _, leaf, name, _ in _QFORMER_LEAVES},
    **{f"{attn}.{name}": leaf for attn in ("self_attn", "cross_attn")
       for name, leaf in (("in_proj_weight", "wq"), ("in_proj_bias", "bq"),
                          ("out_proj.weight", "wo"), ("out_proj.bias", "bo"))},
}


def jax_leaf_name(name: str) -> str:
    """The last key of the JAX parameter path that the port parameter ``name``
    comes from, for a GPT2 (plain or gated cross-attention), a bridge, or a
    CaptionModel (``gpt.*``, ``bridge.*``). Raises KeyError on a name that no
    JAX leaf maps to."""
    bare = name.removeprefix("gpt.").removeprefix("bridge.")
    if bare in _TOP_LEAVES:
        return _TOP_LEAVES[bare]
    parts = bare.split(".")
    if parts[:2] == ["transformer", "h"] and len(parts) > 3 and parts[2].isdigit():
        leaf = _GPT_LAYER_LEAVES.get(".".join(parts[3:]))
    elif parts[0] == "layers" and len(parts) > 2 and parts[1].isdigit():
        leaf = _QFORMER_LAYER_LEAVES.get(".".join(parts[2:]))
    else:
        leaf = None
    if leaf is None:
        raise KeyError(f"no JAX leaf maps to the port parameter {name!r}")
    return leaf


def _paths(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _paths(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}"


def check_jax_paths(tree: Mapping, cfg: GPTConfig = None, bridge_kind: str = None) -> None:
    """Raise KeyError unless the leaf paths of a JAX parameter tree are exactly
    those that ``gpt2_from_jax_params`` (``cfg``) or ``bridge_from_jax_params``
    (``bridge_kind``) reads: a leaf no converter reads is named, never
    dropped."""
    if cfg is not None:
        want = {"wte", "wpe", "lnf/scale", "lnf/bias"}
        leaves = _BLOCK_LEAVES + (_XATTN_BLOCK_LEAVES if cfg.cross_attention else ())
        want |= {f"blocks/{group}/{leaf}" for group, leaf, _, _ in leaves}
        if cfg.cross_attention:
            want |= {"blocks/gate", "vis_proj/w", "vis_proj/b"}
    else:
        want = {"vis_proj/w", "vis_proj/b"}
        if bridge_kind == "qformer":
            want |= {"query_tokens"}
            want |= {f"layers/{group}/{leaf}" for group, leaf, _, _ in _QFORMER_LEAVES}
            want |= {f"layers/{attn}/{w}" for attn in ("self_attn", "cross_attn")
                     for w in ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")}
        elif bridge_kind != "linear":
            raise ValueError(f"no bridge parameters for kind {bridge_kind!r}")
    have = set(_paths(tree))
    if have != want:
        raise KeyError(f"JAX parameter tree: leaves not read {sorted(have - want)[:8]}, "
                       f"leaves missing {sorted(want - have)[:8]}")


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


# CLIP block leaves: JAX (group, name) -> the port's layer name and whether it
# is a Linear weight that torch stores transposed; wqkv / bqkv are split
_CLIP_BLOCK_LEAVES = (
    ("ln1", "scale", "layer_norm1.weight", False),
    ("ln1", "bias", "layer_norm1.bias", False),
    ("attn", "wo", "self_attn.out_proj.weight", True),
    ("attn", "bo", "self_attn.out_proj.bias", False),
    ("ln2", "scale", "layer_norm2.weight", False),
    ("ln2", "bias", "layer_norm2.bias", False),
    ("mlp", "wfc", "mlp.fc1.weight", True),
    ("mlp", "bfc", "mlp.fc1.bias", False),
    ("mlp", "wproj", "mlp.fc2.weight", True),
    ("mlp", "bproj", "mlp.fc2.bias", False),
)


def clip_from_jax_params(params_np, cfg: CLIPConfig) -> Dict[str, torch.Tensor]:
    """The port's fp32 CLIPVisionTower state dict (HF CLIPVisionModel's names
    without ``vision_model.``) from the JAX CLIP ViT parameter tree: the
    layer axis un-stacked, Linear weights transposed to (out, in), the fused
    ``wqkv`` / ``bqkv`` split into q, k and v, the (p * p * 3, width) patch
    matrix back into the conv's (width, 3, p, p). Raises KeyError unless
    the tree holds exactly the leaves read."""
    want = {"patch_w", "cls", "pos", "ln_pre/scale", "ln_pre/bias", "ln_post/scale",
            "ln_post/bias", "blocks/attn/wqkv", "blocks/attn/bqkv"}
    want |= {f"blocks/{group}/{leaf}" for group, leaf, _, _ in _CLIP_BLOCK_LEAVES}
    have = set(_paths(params_np))
    if have != want:
        raise KeyError(f"JAX CLIP tree: leaves not read {sorted(have - want)[:8]}, "
                       f"leaves missing {sorted(want - have)[:8]}")
    w, p = cfg.width, cfg.patch_size
    out = {
        "embeddings.class_embedding": _t(params_np["cls"]),
        "embeddings.patch_embedding.weight": _t(
            np.asarray(params_np["patch_w"]).reshape(p, p, 3, w).transpose(3, 2, 0, 1)),
        "embeddings.position_embedding.weight": _t(params_np["pos"]),
        "pre_layrnorm.weight": _t(params_np["ln_pre"]["scale"]),
        "pre_layrnorm.bias": _t(params_np["ln_pre"]["bias"]),
    }
    blocks = params_np["blocks"]
    for i in range(cfg.layers):
        pre = f"encoder.layers.{i}."
        wqkv = np.asarray(blocks["attn"]["wqkv"][i])
        bqkv = np.asarray(blocks["attn"]["bqkv"][i])
        for j, name in enumerate(("q_proj", "k_proj", "v_proj")):
            out[f"{pre}self_attn.{name}.weight"] = _t(wqkv[:, j * w:(j + 1) * w].T)
            out[f"{pre}self_attn.{name}.bias"] = _t(bqkv[j * w:(j + 1) * w])
        for group, leaf, name, transpose in _CLIP_BLOCK_LEAVES:
            a = np.asarray(blocks[group][leaf][i])
            out[pre + name] = _t(a.T if transpose else a)
    out["post_layernorm.weight"] = _t(params_np["ln_post"]["scale"])
    out["post_layernorm.bias"] = _t(params_np["ln_post"]["bias"])
    return out
