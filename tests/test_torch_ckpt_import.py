"""The port's checkpoint readers against the JAX package's: HF GPT-2 state
dicts, reference and GPT_Caption ``.pt`` files of each bridge, the JAX
``.npz`` with bf16 leaves, a port checkpoint read back by the JAX importer,
the safetensors reader, one reader for every format, and the keys a reader
refuses."""

import os

import jax
import numpy as np
import pytest
import torch

from gpt2_vision_language_tpu.ckpt import checkpoint as jckpt
from gpt2_vision_language_tpu.ckpt import torch_import as jimport
from gpt2_vision_language_tpu.ckpt.torch_export import gpt2_to_torch_state_dict
from gpt2_vision_language_tpu.core.config import BridgeConfig as JaxBridgeConfig
from gpt2_vision_language_tpu.core.config import GPTConfig as JaxGPTConfig
from gpt2_vision_language_tpu.models import caption as jcaption
from gpt2_vision_language_tpu.models import gpt2 as jgpt2
from gpt2_vision_language_tpu_torch.ckpt import torch_import as pimport
from gpt2_vision_language_tpu_torch.ckpt.checkpoint import load_jax_checkpoint, save_checkpoint
from gpt2_vision_language_tpu_torch.ckpt.convert import (
    bridge_from_jax_params,
    check_jax_paths,
    gpt2_from_jax_params,
)
from gpt2_vision_language_tpu_torch.core.config import BridgeConfig, GPTConfig
from gpt2_vision_language_tpu_torch.models import bridges, gpt2

KW = dict(block_size=32, vocab_size=50257, n_layer=2, n_head=2, n_embd=16)
CFG, JCFG = GPTConfig(**KW), JaxGPTConfig(**KW)
BRIDGE = dict(enc_dim=12, n_queries=4, n_layers=2, n_heads=2)


@pytest.fixture(scope="module")
def jax_params():
    """Seeded JAX params with the padding rows of wte at 0, as a file with an
    unpadded vocab reads back."""
    params = jax.tree.map(np.array, jgpt2.init(jax.random.PRNGKey(0), JCFG))
    params["wte"][JCFG.vocab_size:] = 0.0
    return params


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def assert_same_state_dict(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], want[k]), k


def hf_state_dict(params, prefix):
    """HF GPT2LMHeadModel layout: Conv1D weights (in, out), vocab 50257, the
    causal-mask buffers, a tied lm_head."""
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in gpt2_to_torch_state_dict(params, JCFG).items()}
    out = {}
    for k, v in sd.items():
        if k == "lm_head.weight":
            continue
        bare = k.removeprefix("transformer.")
        if bare.endswith(("c_attn.weight", "c_proj.weight", "c_fc.weight")):
            v = v.t().contiguous()
        out[prefix + bare] = v[:50257] if bare == "wte.weight" else v
    for i in range(JCFG.n_layer):
        out[f"{prefix}h.{i}.attn.bias"] = torch.tril(torch.ones(1, 1, 32, 32))
        out[f"{prefix}h.{i}.attn.masked_bias"] = torch.tensor(-1e4)
    out["lm_head.weight"] = out[prefix + "wte.weight"]
    return out


@pytest.mark.parametrize("prefix", ["transformer.", ""])
def test_hf_state_dict_equals_the_jax_import(jax_params, prefix):
    sd = hf_state_dict(jax_params, prefix)
    want = gpt2_from_jax_params(_np_tree(jimport.gpt2_from_hf_state_dict(sd, JCFG)), CFG)
    got = pimport.gpt2_from_hf_state_dict(sd, CFG)
    assert_same_state_dict(got, want)
    assert got["lm_head.weight"] is got["transformer.wte.weight"]
    assert got["transformer.wte.weight"].shape[0] == 50304
    assert not got["transformer.wte.weight"][50257:].any()
    gpt2.GPT2(CFG).load_state_dict(got)


@pytest.mark.parametrize("kind", ["linear", "qformer"])
def test_gpt_caption_pt_equals_the_jax_import(jax_params, tmp_path, kind):
    """A GPT_Caption .pt (gpt.* + bridge.*, the bridge in torch's layout)
    through both packages' readers: the same decoder and bridge state dicts."""
    bcfg = BridgeConfig(kind=kind, **BRIDGE)
    bridge = bridges.bridge_init(bcfg, CFG.n_embd, generator=torch.Generator().manual_seed(1))
    sd = {f"gpt.{k}": torch.from_numpy(np.ascontiguousarray(v))
          for k, v in gpt2_to_torch_state_dict(jax_params, JCFG).items()}
    sd.update({f"bridge.{k}": v for k, v in bridge.state_dict().items()})
    path = str(tmp_path / "caption.pt")
    torch.save({"model": sd, "step": 5}, path)

    raw, meta = pimport.load_torch_checkpoint(path)
    assert meta == {"step": 5}
    gsd, bsd = pimport.split_caption_state_dict(raw)
    jsd, _ = jimport.load_torch_checkpoint(path)
    jgsd = {k.removeprefix("gpt."): v for k, v in jsd.items() if k.startswith("gpt.")}
    want = gpt2_from_jax_params(_np_tree(jimport.gpt2_from_torch_state_dict(jgsd, JCFG)), CFG)
    assert_same_state_dict(pimport.gpt2_from_torch_state_dict(gsd, CFG), want)
    if kind == "linear":
        jbridge, got = jimport.linear_bridge_from_torch(jsd), pimport.linear_bridge_from_torch(bsd)
    else:
        jbridge = jimport.qformer_bridge_from_torch(jsd, BRIDGE["n_layers"])
        got = pimport.qformer_bridge_from_torch(bsd, BRIDGE["n_layers"])
    assert_same_state_dict(got, bridge_from_jax_params(_np_tree(jbridge), bcfg))
    assert_same_state_dict(got, {k: v.detach() for k, v in bridge.state_dict().items()})


@pytest.mark.parametrize("kind", ["linear", "qformer"])
@pytest.mark.parametrize("layout", ["caption-pt", "bridge-pt", "finetune-npz", "bridge-npz"])
def test_bridge_from_every_file_through_read_checkpoint(jax_params, tmp_path, kind, layout):
    """read_checkpoint + bridge_from_checkpoint (eval_quality's --gpt-ckpt and
    --bridge-ckpt): a GPT_Caption .pt, a bridge-only .pt, a JAX fine-tune
    .npz ({gpt, bridge}) and a bridge-only .npz all give the bridge's own
    state dict; an HF file holds none."""
    bcfg = BridgeConfig(kind=kind, **BRIDGE)
    jbridge = jax.tree.map(np.array, jcaption.init(jax.random.PRNGKey(2), JCFG,
                                                   JaxBridgeConfig(kind=kind, **BRIDGE)))
    want = bridge_from_jax_params(_np_tree(jbridge), bcfg)
    bsd = {f"bridge.{k}": v for k, v in want.items()}
    if layout.endswith("pt"):
        path = str(tmp_path / "b.pt")
        gsd = {f"gpt.{k}": torch.from_numpy(np.ascontiguousarray(v))
               for k, v in gpt2_to_torch_state_dict(jax_params, JCFG).items()}
        torch.save({"model": {**gsd, **bsd} if layout == "caption-pt" else bsd}, path)
    else:
        path = str(tmp_path / "b.npz")
        params = ({"gpt": jax_params, "bridge": jbridge} if layout == "finetune-npz"
                  else {"bridge": jbridge})
        jckpt.save_checkpoint(path, {"params": params})
    raw = pimport.read_checkpoint(path)
    assert raw.fmt == ("npz" if layout.endswith("npz") else "reference-pt")
    assert_same_state_dict(pimport.bridge_from_checkpoint(raw, kind), want)
    if layout in ("caption-pt", "finetune-npz"):
        assert_same_state_dict(pimport.gpt2_from_checkpoint(raw, CFG),
                               gpt2_from_jax_params(jax_params, CFG))
    with pytest.raises(ValueError, match="holds no bridge"):
        pimport.bridge_from_checkpoint(raw._replace(fmt="hf"), kind)


def test_jax_npz_with_bf16_leaves_reads_back_exactly(tmp_path):
    rng = np.random.RandomState(0)
    tree = {"params": {"w": jax.numpy.asarray(rng.randn(5, 7), jax.numpy.bfloat16),
                       "blocks": {"b": rng.randn(3).astype(np.float32)}},
            "opt_state": {"step": np.asarray(4, np.int32)}}
    path = str(tmp_path / "model_best.npz")
    jckpt.save_checkpoint(path, tree, meta={"step": 4, "val_loss": 3.5})
    got, meta = load_jax_checkpoint(path)
    want, want_meta = jckpt.load_checkpoint(path)
    assert meta == want_meta == {"step": 4, "val_loss": 3.5}
    assert got["params"]["w"].dtype == np.float32
    np.testing.assert_array_equal(got["params"]["w"], np.asarray(want["params"]["w"], np.float32))
    np.testing.assert_array_equal(got["params"]["blocks"]["b"], want["params"]["blocks"]["b"])
    assert got["opt_state"]["step"] == 4


def test_port_checkpoint_reads_back_through_the_jax_importer(jax_params, tmp_path):
    """JAX params -> the port's model -> ckpt/checkpoint.save_checkpoint -> the
    JAX load_torch_checkpoint + gpt2_from_torch_state_dict: bit for bit."""
    model = gpt2.GPT2(CFG)
    model.load_state_dict(gpt2_from_jax_params(jax_params, CFG))
    path = str(tmp_path / "model_last.pt")
    save_checkpoint(path, {"model": model.state_dict(), "opt_state": {"step": 0}},
                    {"step": 0, "next_step": 0})
    sd, _ = jimport.load_torch_checkpoint(path)
    back = jimport.gpt2_from_torch_state_dict(sd, JCFG)
    flat_want = jax.tree_util.tree_leaves_with_path(jax_params)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_got) == len(flat_want)
    for path_, leaf in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[path_]), leaf, err_msg=str(path_))


def test_safetensors_reader_equals_the_library(tmp_path):
    st = pytest.importorskip("safetensors")
    from safetensors.numpy import load_file as np_load
    from safetensors.torch import load_file as torch_load, save_file

    del st
    g = torch.Generator().manual_seed(0)
    plain = {"a": torch.randn(3, 4, generator=g), "b": torch.randn(5, generator=g).half(),
             "empty": torch.zeros(0, 3)}
    save_file(plain, str(tmp_path / "x.safetensors"), metadata={"format": "pt"})
    got = pimport.read_safetensors(str(tmp_path / "x.safetensors"))
    want = np_load(str(tmp_path / "x.safetensors"))
    assert set(got) == set(want)
    for k in want:
        assert got[k].numpy().dtype == want[k].dtype
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    save_file({"c": torch.randn(2, 3, generator=g).bfloat16()}, str(tmp_path / "y.safetensors"))
    got = pimport.read_safetensors(str(tmp_path / "y.safetensors"))
    assert torch.equal(got["c"], torch_load(str(tmp_path / "y.safetensors"))["c"])
    save_file({"i": torch.arange(4, dtype=torch.int32)}, str(tmp_path / "z.safetensors"))
    with pytest.raises(ValueError, match="'i' has dtype I32"):
        pimport.read_safetensors(str(tmp_path / "z.safetensors"))


@pytest.fixture(scope="module")
def every_format(jax_params, tmp_path_factory):
    """One decoder's weights written in every format the readers take."""
    pytest.importorskip("safetensors")
    from safetensors.torch import save_file

    root = tmp_path_factory.mktemp("formats")
    files = {}
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in gpt2_to_torch_state_dict(jax_params, JCFG).items()}
    files["reference-pt"] = str(root / "model.pt")
    torch.save({"model": sd, "step": 1}, files["reference-pt"])
    files["caption-pt"] = str(root / "caption.pt")
    bridge = bridges.bridge_init(BridgeConfig(kind="linear", **BRIDGE), CFG.n_embd)
    torch.save({"model": {**{f"gpt.{k}": v for k, v in sd.items()},
                          **{f"bridge.{k}": v for k, v in bridge.state_dict().items()}}},
               files["caption-pt"])
    hf = hf_state_dict(jax_params, "transformer.")
    os.makedirs(root / "hf_bin")
    torch.save(hf, str(root / "hf_bin" / "pytorch_model.bin"))
    files["hf-bin"] = str(root / "hf_bin")
    os.makedirs(root / "hf_st")
    hf.pop("lm_head.weight")  # safetensors stores a tied tensor once
    save_file(hf, str(root / "hf_st" / "model.safetensors"))
    files["hf-safetensors"] = str(root / "hf_st")
    files["npz"] = str(root / "model.npz")
    jckpt.save_checkpoint(files["npz"], {"params": {
        "gpt": jax_params,
        "bridge": jcaption.init(jax.random.PRNGKey(1), JCFG, JaxBridgeConfig(
            kind="linear", **BRIDGE))}})
    return files


@pytest.mark.parametrize("fmt", ["reference-pt", "caption-pt", "hf-bin", "hf-safetensors",
                                 "npz"])
def test_one_reader_for_every_format(jax_params, every_format, fmt):
    """load_gpt_checkpoint (the trainer's bootstrap) gives the same state dict
    from every format, and load_pretrained_gpt loads it."""
    from gpt2_vision_language_tpu_torch.train.finetune import load_pretrained_gpt

    sd, _ = pimport.load_gpt_checkpoint(every_format[fmt], CFG)
    assert_same_state_dict(sd, gpt2_from_jax_params(jax_params, CFG))
    model = load_pretrained_gpt(CFG, every_format[fmt], device="cpu")
    assert torch.equal(model.transformer.h[1].mlp.c_fc.weight,
                       sd["transformer.h.1.mlp.c_fc.weight"])
    # a plain decoder's file for the cross-attention model: the plain leaves
    # load, the cross-attention leaves keep their init
    xcfg = CFG.replace(cross_attention=True, img_embd=12)
    xmodel = load_pretrained_gpt(xcfg, every_format[fmt], device="cpu")
    assert torch.equal(xmodel.transformer.wpe.weight, sd["transformer.wpe.weight"])


def test_readers_name_what_they_do_not_read(jax_params):
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in gpt2_to_torch_state_dict(jax_params, JCFG).items()}
    with pytest.raises(KeyError, match="transformer.h.0.attn.rotary.weight"):
        pimport.gpt2_from_torch_state_dict({**sd, "transformer.h.0.attn.rotary.weight":
                                            torch.zeros(1)}, CFG)
    with pytest.raises(KeyError, match="transformer.h.2.ln_1.weight"):
        pimport.gpt2_from_torch_state_dict({**sd, "transformer.h.2.ln_1.weight":
                                            torch.zeros(16)}, CFG)
    with pytest.raises(ValueError, match="lm_head"):
        pimport.gpt2_from_torch_state_dict({**sd, "lm_head.weight": sd["lm_head.weight"] + 1},
                                           CFG)
    with pytest.raises(KeyError, match="h.0.mlp.c_gate.weight"):
        pimport.gpt2_from_hf_state_dict({**hf_state_dict(jax_params, ""),
                                         "h.0.mlp.c_gate.weight": torch.zeros(1)}, CFG)
    with pytest.raises(KeyError, match="optimizer"):
        pimport.split_caption_state_dict({"gpt.transformer.wte.weight": 0, "optimizer": 0})
    qsd = {f"bridge.{k}": v for k, v in bridges.bridge_init(
        BridgeConfig(kind="qformer", **BRIDGE), CFG.n_embd).state_dict().items()}
    with pytest.raises(KeyError, match="unrecognised bridge keys"):
        pimport.linear_bridge_from_torch(qsd)
    with pytest.raises(KeyError, match="bridge.layers.1"):
        pimport.qformer_bridge_from_torch(qsd, 1)
    with pytest.raises(KeyError, match="blocks/extra/w"):
        check_jax_paths({**jax_params, "blocks": {**jax_params["blocks"],
                                                  "extra": {"w": 0}}}, CFG)
