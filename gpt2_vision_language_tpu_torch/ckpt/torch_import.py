"""Readers of GPT-2 checkpoints from outside the port, into the port's state
dicts.

Counterpart of gpt2_vision_language_tpu/ckpt/torch_import.py. Each reader
returns a state dict that the port's ``GPT2`` / bridge modules take with
``load_state_dict`` (fp32, torch's (out, in) Linear layout, the vocab
zero-padded to ``cfg.padded_vocab_size``, ``lm_head.weight`` tied to
``transformer.wte.weight``):

  * ``load_torch_checkpoint`` + ``gpt2_from_torch_state_dict``: a reference
    ``.pt`` (``{"model": state_dict, ...}``, train_gpt2.py:363-391; the port's
    own checkpoints have the same layout), the plain decoder or the gated
    cross-attention one (gpt2_cross-att/model.py:116-129);
  * ``gpt2_from_hf_state_dict``: HuggingFace GPT2LMHeadModel weights (keys
    with or without ``transformer.``, Conv1D weights stored (in, out));
    ``load_hf_state_dict`` reads a directory, a ``pytorch_model.bin`` or a
    ``model.safetensors`` (``read_safetensors``: the format read here, no
    ``safetensors`` package needed);
  * ``linear_bridge_from_torch`` / ``qformer_bridge_from_torch``: the bridge
    half of a GPT_Caption ``.pt`` (gpt2_linear/train.py:170-216), whose packed
    ``in_proj_weight`` is already the port's layout (models/bridges.py);
  * ``clip_from_hf_state_dict``: HF CLIPVisionModel (or full CLIPModel)
    weights into the port's CLIP encoder (models/clip_vit.py), read from a
    directory or file by ``load_hf_state_dict``, without ``transformers``;
  * ``read_checkpoint``: any of these files, or a JAX ``.npz``
    (ckpt/checkpoint.load_jax_checkpoint), as read, the one place that tells
    the formats apart; ``gpt2_from_checkpoint`` / ``bridge_from_checkpoint``
    convert its result, ``load_gpt_checkpoint`` gives the decoder in one call.

The causal-mask buffers some versions save (``.attn.bias``,
``.attn.masked_bias``) are dropped. Any other key a reader does not
recognise raises KeyError with its name: nothing is skipped in silence.
"""

from __future__ import annotations

import json
import os
import re
import struct
from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from ..core.config import BridgeConfig, CLIPConfig, GPTConfig
from .checkpoint import load_jax_checkpoint
from .convert import (
    _BLOCK_LEAVES, _QFORMER_LAYER_LEAVES, _XATTN_BLOCK_LEAVES, bridge_from_jax_params,
    check_jax_paths, gpt2_from_jax_params,
)

_LAYER_NAMES = {name for _, _, name, _ in _BLOCK_LEAVES}
_XATTN_NAMES = {name for _, _, name, _ in _XATTN_BLOCK_LEAVES} | {"cross_gate"}
_CONV1D = {name for _, _, name, transpose in _BLOCK_LEAVES if transpose}
_TOP_NAMES = {"transformer.wte.weight", "transformer.wpe.weight",
              "transformer.ln_f.weight", "transformer.ln_f.bias"}
_XATTN_TOP = {"transformer.vis_proj.z_proj.weight", "transformer.vis_proj.z_proj.bias"}
_LAYER_KEY = re.compile(r"transformer\.h\.(\d+)\.(.+)")


def _f32(x) -> torch.Tensor:
    """A detached fp32 CPU copy of a tensor or numpy array."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x)
    return x.detach().to("cpu", torch.float32).clone()


def _is_mask_buffer(key: str) -> bool:
    return key.endswith((".attn.bias", ".attn.masked_bias"))


def _tie(sd: Dict[str, torch.Tensor], lm_head, cfg: GPTConfig) -> Dict[str, torch.Tensor]:
    """Zero-pad wte to cfg.padded_vocab_size rows and tie lm_head to it; a
    saved lm_head must equal the saved wte (the reference ties them)."""
    if "transformer.wte.weight" not in sd:
        raise KeyError("checkpoint has no transformer.wte.weight")
    wte = sd["transformer.wte.weight"]
    if lm_head is not None and not torch.equal(_f32(lm_head), wte):
        raise ValueError("lm_head.weight differs from transformer.wte.weight: the "
                         "GPT-2 of this repository ties them")
    pad = cfg.padded_vocab_size - wte.shape[0]
    if pad < 0:
        raise ValueError(f"wte has {wte.shape[0]} rows, more than the "
                         f"{cfg.padded_vocab_size} of the config")
    if pad:
        wte = torch.cat([wte, wte.new_zeros(pad, wte.shape[1])])
    sd["transformer.wte.weight"] = sd["lm_head.weight"] = wte
    return sd


def _check_gpt_key(key: str, cfg: GPTConfig) -> None:
    if key in _TOP_NAMES or (cfg.cross_attention and key in _XATTN_TOP):
        return
    m = _LAYER_KEY.fullmatch(key)
    if m and int(m.group(1)) < cfg.n_layer and (
            m.group(2) in _LAYER_NAMES or (cfg.cross_attention and m.group(2) in _XATTN_NAMES)):
        return
    raise KeyError(f"unrecognised GPT-2 state-dict key {key!r} for n_layer={cfg.n_layer}, "
                   f"cross_attention={cfg.cross_attention}")


def load_torch_checkpoint(path: str):
    """Load a reference ``.pt`` -> (state_dict, meta): the dict under "model"
    if there is one, else the file's dict itself. A full unpickle, as the
    reference's files hold more than tensors (its config, the optimizer):
    load only files you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt["model"] if isinstance(ckpt, dict) and "model" in ckpt else ckpt
    meta = ({k: v for k, v in ckpt.items() if k != "model"}
            if isinstance(ckpt, dict) and "model" in ckpt else {})
    return sd, meta


def gpt2_from_torch_state_dict(sd: Mapping, cfg: GPTConfig) -> Dict[str, torch.Tensor]:
    """The port's state dict from a reference-layout one (``transformer.*``
    names, Linear weights (out, in)). Only the keys present are converted (a
    plain decoder's file leaves the cross-attention leaves to the caller)."""
    out, lm_head = {}, None
    for key, v in sd.items():
        if _is_mask_buffer(key):
            continue
        if key == "lm_head.weight":
            lm_head = v
            continue
        _check_gpt_key(key, cfg)
        out[key] = _f32(v)
    return _tie(out, lm_head, cfg)


def gpt2_from_hf_state_dict(sd: Mapping, cfg: GPTConfig) -> Dict[str, torch.Tensor]:
    """The port's state dict from HuggingFace GPT2LMHeadModel weights (e.g.
    the original OpenAI checkpoints): keys with or without ``transformer.``,
    Conv1D weights (in, out) transposed to torch's (out, in), an unpadded
    vocab zero-padded."""
    out, lm_head = {}, None
    for key, v in sd.items():
        bare = key.removeprefix("transformer.")
        if _is_mask_buffer(bare):
            continue
        if bare == "lm_head.weight":
            lm_head = v
            continue
        name = "transformer." + bare
        _check_gpt_key(name, cfg.replace(cross_attention=False))
        m = _LAYER_KEY.fullmatch(name)
        t = _f32(v)
        out[name] = t.t().contiguous() if m and m.group(2) in _CONV1D else t
    return _tie(out, lm_head, cfg)


def _bridge_part(sd: Mapping, prefix: str, names) -> Dict[str, torch.Tensor]:
    """The keys under ``prefix``, stripped, fp32; exactly ``names``."""
    sub = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    missing, extra = set(names) - set(sub), set(sub) - set(names)
    if extra:
        raise KeyError(f"unrecognised bridge keys {sorted(prefix + k for k in extra)[:8]}")
    if missing:
        raise KeyError(f"bridge keys missing: {sorted(prefix + k for k in missing)[:8]}")
    return {k: _f32(v) for k, v in sub.items()}


def _expect_shape(sd, name, shape):
    if tuple(sd[name].shape) != tuple(shape):
        raise ValueError(f"bridge {name}: shape {tuple(sd[name].shape)}, expected {tuple(shape)}")


def linear_bridge_from_torch(sd: Mapping, prefix: str = "bridge.") -> Dict[str, torch.Tensor]:
    """Linear_Bridge (gpt2_linear/model.py:114-129): one vis_proj Linear."""
    out = _bridge_part(sd, prefix, ("vis_proj.weight", "vis_proj.bias"))
    _expect_shape(out, "vis_proj.bias", out["vis_proj.weight"].shape[:1])
    return out


def qformer_bridge_from_torch(sd: Mapping, n_layers: int,
                              prefix: str = "bridge.") -> Dict[str, torch.Tensor]:
    """BLIP2Bridge (gpt2_q_former/model.py:147-168): vis_proj, query_tokens and
    ``n_layers`` layers, their attentions in torch nn.MultiheadAttention's
    packed layout (the port's own)."""
    names = ["vis_proj.weight", "vis_proj.bias", "query_tokens"]
    names += [f"layers.{i}.{n}" for i in range(n_layers) for n in _QFORMER_LAYER_LEAVES]
    out = _bridge_part(sd, prefix, names)
    d = out["vis_proj.weight"].shape[0]
    _expect_shape(out, "vis_proj.bias", (d,))
    _expect_shape(out, "query_tokens", (out["query_tokens"].shape[0], d))
    for i in range(n_layers):
        pre = f"layers.{i}."
        for a in ("self_attn", "cross_attn"):
            _expect_shape(out, f"{pre}{a}.in_proj_weight", (3 * d, d))
            _expect_shape(out, f"{pre}{a}.in_proj_bias", (3 * d,))
            _expect_shape(out, f"{pre}{a}.out_proj.weight", (d, d))
            _expect_shape(out, f"{pre}{a}.out_proj.bias", (d,))
        hidden = out[pre + "mlp.0.weight"].shape[0]
        _expect_shape(out, pre + "mlp.0.weight", (hidden, d))
        _expect_shape(out, pre + "mlp.2.weight", (d, hidden))
    return out


# safetensors dtypes this reader takes
_ST_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Read a ``.safetensors`` file: 8 bytes of little-endian header length,
    a JSON header {name: {"dtype", "shape", "data_offsets"}, "__metadata__"},
    then the raw little-endian buffers. F32, F16 and BF16 tensors; any other
    dtype raises."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}, "
                             f"not one of {sorted(_ST_DTYPES)}")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        numel = 1
        for s in shape:
            numel *= s
        if end - begin != numel * dtype.itemsize:
            raise ValueError(f"{path}: tensor {name!r} spans {end - begin} bytes, "
                             f"its shape {shape} needs {numel * dtype.itemsize}")
        buf = bytearray(data[begin:end])
        t = torch.frombuffer(buf, dtype=dtype) if numel else torch.empty(0, dtype=dtype)
        out[name] = t.reshape(shape)
    return out


def load_hf_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """An HF checkpoint directory (``pytorch_model.bin``, else
    ``model.safetensors``) or either weights file -> its state dict."""
    if os.path.isdir(path):
        for name in ("pytorch_model.bin", "model.safetensors"):
            if os.path.exists(os.path.join(path, name)):
                path = os.path.join(path, name)
                break
        else:
            raise FileNotFoundError(f"no pytorch_model.bin / model.safetensors in {path}")
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    return torch.load(path, map_location="cpu", weights_only=True)


# keys of an HF CLIP file that the vision tower does not use, accepted by
# name: the rest of a full CLIPModel file, and the position-id buffer
_CLIP_UNUSED = {"visual_projection.weight", "text_projection.weight", "logit_scale",
                "vision_model.embeddings.position_ids"}


def clip_from_hf_state_dict(sd: Mapping, cfg: CLIPConfig) -> Dict[str, torch.Tensor]:
    """HF ``CLIPVisionModel`` (or full ``CLIPModel``) weights -> the state
    dict of the port's ``CLIPVisionTower``: ``vision_model.*`` with the prefix
    removed, fp32 CPU copies, key for key (the tower has HF's names and
    shapes). The keys of a full CLIPModel file that the vision tower does
    not use (``text_model.*``, ``visual_projection.weight``,
    ``text_projection.weight``, ``logit_scale``) and the ``position_ids``
    buffer are accepted by name and not read; any other key raises, and so
    does a key the tower needs that is missing or of another shape."""
    from ..models.clip_vit import CLIPVisionTower

    with torch.device("meta"):
        want = {k: tuple(v.shape) for k, v in CLIPVisionTower(cfg).state_dict().items()}
    out, unknown = {}, []
    for key, val in sd.items():
        if key in _CLIP_UNUSED or key.startswith("text_model."):
            continue
        name = key.removeprefix("vision_model.")
        if name == key or name not in want:
            unknown.append(key)
            continue
        t = _f32(val)
        if tuple(t.shape) != want[name]:
            raise ValueError(f"CLIP key {key!r}: shape {tuple(t.shape)}, the encoder of "
                             f"{cfg} needs {want[name]}")
        out[name] = t
    if unknown:
        raise KeyError(f"unrecognised CLIP state-dict keys: {unknown[:8]}")
    missing = sorted(set(want) - set(out))
    if missing:
        raise KeyError(f"the CLIP state dict lacks {missing[:8]}")
    return out


def checkpoint_format(path: str) -> str:
    """"hf" (a directory, ``.bin`` or ``.safetensors``), "npz" (the JAX
    package's) or "reference-pt" (a ``.pt``: the reference's or the port's)."""
    if os.path.isdir(path) or path.endswith((".bin", ".safetensors")):
        return "hf"
    return "npz" if path.endswith(".npz") else "reference-pt"


def split_caption_state_dict(sd: Mapping) -> Tuple[Mapping, Optional[Mapping]]:
    """A GPT_Caption state dict (``gpt.*`` + ``bridge.*``) -> (the decoder's
    state dict, the ``bridge.*`` entries); any other state dict -> (it, None)."""
    if not any(k.startswith("gpt.") for k in sd):
        return sd, None
    other = [k for k in sd if not k.startswith(("gpt.", "bridge."))]
    if other:
        raise KeyError(f"GPT_Caption checkpoint: keys outside gpt.* and bridge.*: {other[:8]}")
    return ({k[4:]: v for k, v in sd.items() if k.startswith("gpt.")},
            {k: v for k, v in sd.items() if k.startswith("bridge.")})


def gpt2_from_jax_tree(params: Mapping, cfg: GPTConfig) -> Dict[str, torch.Tensor]:
    """The port's state dict from a JAX GPT-2 tree (an ``.npz``'s params),
    every leaf read: ckpt/convert.check_jax_paths first."""
    check_jax_paths(params, cfg)
    return gpt2_from_jax_params(params, cfg)


def bridge_from_jax_tree(params: Mapping, kind: str) -> Dict[str, torch.Tensor]:
    check_jax_paths(params, bridge_kind=kind)
    return bridge_from_jax_params(params, BridgeConfig(kind=kind))


class RawCheckpoint(NamedTuple):
    """A checkpoint as read, before conversion: ``fmt`` as
    ``checkpoint_format`` names it; ``gpt`` the decoder (a torch or HF state
    dict, or the JAX tree for "npz"); ``bridge`` a GPT_Caption file's
    ``bridge.*`` entries or an ``.npz`` fine-tune's bridge tree, else None."""

    fmt: str
    gpt: Mapping
    bridge: Optional[Mapping]


def read_checkpoint(path: str, fmt: Optional[str] = None) -> RawCheckpoint:
    """Read any checkpoint this repository takes: a reference or port ``.pt``
    (a GPT_Caption file split into its halves), an HF directory or weights
    file, or a JAX ``.npz`` (pretrain ``{params: gpt}`` or fine-tune
    ``{params: {gpt, bridge}}``). ``fmt`` overrides the format the path
    names. The one place that tells the formats apart."""
    fmt = fmt or checkpoint_format(path)
    if fmt == "hf":
        return RawCheckpoint(fmt, load_hf_state_dict(path), None)
    if fmt == "npz":
        tree, _ = load_jax_checkpoint(path)
        params = tree["params"]
        return RawCheckpoint(fmt, params.get("gpt", params), params.get("bridge"))
    sd, _ = load_torch_checkpoint(path)
    return RawCheckpoint(fmt, *split_caption_state_dict(sd))


def gpt2_from_checkpoint(raw: RawCheckpoint, cfg: GPTConfig) -> Dict[str, torch.Tensor]:
    """The port's decoder state dict from ``read_checkpoint``'s result. A
    plain decoder's ``.npz`` read for a cross-attention ``cfg`` gives the
    plain leaves; the caller keeps the rest at their init."""
    if raw.fmt == "hf":
        return gpt2_from_hf_state_dict(raw.gpt, cfg)
    if raw.fmt == "npz":
        if cfg.cross_attention and "xattn" not in raw.gpt["blocks"]:
            cfg = cfg.replace(cross_attention=False)
        return gpt2_from_jax_tree(raw.gpt, cfg)
    return gpt2_from_torch_state_dict(raw.gpt, cfg)


def bridge_from_checkpoint(raw: RawCheckpoint, kind: str) -> Dict[str, torch.Tensor]:
    """The port's ``kind`` bridge state dict ("linear" or "qformer") from
    ``read_checkpoint``'s result: its bridge half, or the whole file where
    it holds the bridge alone (``bridge.*`` keys, or a bridge tree)."""
    part = raw.gpt if raw.bridge is None else raw.bridge
    if raw.fmt == "npz":
        return bridge_from_jax_tree(part, kind)
    if raw.fmt != "reference-pt":
        raise ValueError(f"a {raw.fmt} checkpoint holds no bridge")
    if kind == "qformer":
        layers = {int(k.split(".")[2]) for k in part if k.startswith("bridge.layers.")}
        return qformer_bridge_from_torch(part, 1 + max(layers, default=-1))
    return linear_bridge_from_torch(part)


def load_gpt_checkpoint(path: str, cfg: GPTConfig) -> Tuple[Dict[str, torch.Tensor], str]:
    """The decoder of any checkpoint ``read_checkpoint`` takes -> (the port's
    state dict, format); a GPT_Caption file's bridge half is not read."""
    raw = read_checkpoint(path)
    if raw.fmt == "reference-pt" and raw.bridge:
        print(f"[ckpt] {path}: {len(raw.bridge)} bridge.* leaves not read (the decoder only)")
    return gpt2_from_checkpoint(raw, cfg), raw.fmt
