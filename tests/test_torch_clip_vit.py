"""The PyTorch port's CLIP ViT encoder (models/clip_vit.py) against the JAX
package's on the same inputs, made from a numpy seed: the presets field for
field, quick_gelu bit for bit in bf16, features at fp32 and bf16 with and
without ln_post, patchify against a stride-p conv, preprocess when enlarging
and when shrinking, the two weight converters (JAX tree and HF state dict)
against each other, and an HF CLIPVisionModel's last_hidden_state, its
save_pretrained directory read back without transformers."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt2_vision_language_tpu.core import config as jax_config
from gpt2_vision_language_tpu.core.precision import DEFAULT_POLICY as JAX_BF16
from gpt2_vision_language_tpu.core.precision import FP32_POLICY as JAX_FP32
from gpt2_vision_language_tpu.models import clip_vit as jclip
from gpt2_vision_language_tpu_torch.ckpt import torch_import
from gpt2_vision_language_tpu_torch.ckpt.convert import clip_from_jax_params
from gpt2_vision_language_tpu_torch.core import config as port_config
from gpt2_vision_language_tpu_torch.core.precision import DEFAULT_POLICY, FP32_POLICY
from gpt2_vision_language_tpu_torch.models import clip_vit
from torch_threads import share_cores  # noqa: F401  (autouse)

TINY = port_config.CLIP_TINY


@pytest.mark.parametrize("preset", ["CLIP_VIT_L14", "CLIP_VIT_B16", "CLIP_TINY"])
def test_presets_match_jax(preset):
    j, p = getattr(jax_config, preset), getattr(port_config, preset)
    assert [(f.name, f.default) for f in dataclasses.fields(port_config.CLIPConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(jax_config.CLIPConfig)]
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    assert (p.grid, p.num_tokens) == (j.grid, j.num_tokens)
    assert port_config.CLIP_VIT_L14.num_tokens == 257 and port_config.CLIP_VIT_B16.num_tokens == 197


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_quick_gelu_matches_jax(dtype):
    """bf16: bit for bit (JAX rounds the constant to bf16, 1.703125, and
    every step of 1 / (1 + exp(-t)) to bf16); fp32: within 1e-6 (the two
    exp implementations)."""
    x = np.random.RandomState(0).randn(50_000).astype(np.float32) * 4
    want = np.asarray(jclip.quick_gelu(jnp.asarray(x).astype(dtype)).astype(jnp.float32))
    got = clip_vit.quick_gelu(torch.from_numpy(x).to(getattr(torch, dtype))).float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def tiny_pair():
    """The JAX init of CLIP_TINY and the port's tower with the same weights
    (through clip_from_jax_params)."""
    params = jclip.init(jax.random.PRNGKey(0), jax_config.CLIP_TINY)
    model = clip_vit.CLIPVisionTower(TINY)
    model.load_state_dict(clip_from_jax_params(jax.tree.map(np.asarray, params), TINY))
    return params, model


@pytest.mark.parametrize("apply_ln_post", [True, False])
@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_features_match_jax(tiny_pair, policy, apply_ln_post):
    """fp32: within 1e-5. bf16: within 2^-6 of max|ref| elementwise and 2^-9
    on average: the blocks carry bf16, so a last-bit difference of an fp32
    accumulation flips a bf16 rounding now and then, and that moves by one
    ulp (2^-8 relative) what follows (read: 0.023 of max 2.83 with ln_post,
    0.062 of 7.5 without)."""
    params, model = tiny_pair
    imgs = np.random.RandomState(2).randn(3, 32, 32, 3).astype(np.float32)
    jp, pp = (JAX_FP32, FP32_POLICY) if policy == "fp32" else (JAX_BF16, DEFAULT_POLICY)
    want = np.asarray(jclip.features(params, jnp.asarray(imgs), jax_config.CLIP_TINY,
                                     policy=jp, apply_ln_post=apply_ln_post)).astype(np.float32)
    with torch.no_grad():
        got = clip_vit.features(model, torch.from_numpy(imgs), TINY, policy=pp,
                                apply_ln_post=apply_ln_post)
    assert got.shape == (3, TINY.num_tokens, TINY.width)
    assert got.dtype == pp.compute_dtype
    got = got.float().numpy()
    if policy == "fp32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        err = np.abs(got - want)
        scale = np.abs(want).max()
        assert err.max() <= 2.0 ** -6 * scale, (err.max(), scale)
        assert err.mean() <= 2.0 ** -9 * scale, (err.mean(), scale)


def test_patchify_matches_conv():
    """patchify + the matmul with patch_weight == a stride-p conv2d with the
    conv weight, as the JAX test holds its patchify."""
    rng = np.random.RandomState(1)
    imgs = rng.randn(2, 32, 32, 3).astype(np.float32)
    model = clip_vit.init(TINY, generator=torch.Generator().manual_seed(3))
    w = model.embeddings.patch_embedding.weight.detach()
    ref = torch.nn.functional.conv2d(torch.from_numpy(imgs.transpose(0, 3, 1, 2)), w, stride=16)
    ref = ref.flatten(2).transpose(1, 2)
    got = clip_vit.patchify(torch.from_numpy(imgs), 16) @ clip_vit.patch_weight(model).detach().t()
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    jp = np.asarray(jclip.patchify(jnp.asarray(imgs), 16))
    np.testing.assert_array_equal(clip_vit.patchify(torch.from_numpy(imgs), 16).numpy(), jp)


@pytest.mark.parametrize("shape, size", [
    ((2, 48, 64, 3), 32),     # enlarge (the JAX test's shape)
    ((2, 20, 30, 3), 32),     # enlarge
    ((2, 300, 400, 3), 224),  # shrink: antialiased
    ((1, 400, 260, 3), 224),  # shrink, portrait
    ((1, 100, 224, 3), 224),  # enlarge, one side longer than the crop
    ((1, 224, 224, 3), 224),  # no resize
])
def test_preprocess_matches_jax(shape, size):
    """Within 2e-5 of the [0, 1] image (the normalised difference times the
    CLIP std). The port's two products with the separable weight matrices
    stay within 2e-7 of an fp64 evaluation; the JAX einsum on the CPU is the
    one off it, by up to 1.3e-5 when shrinking."""
    u8 = np.random.RandomState(4).randint(0, 256, shape).astype(np.uint8)
    want = np.asarray(jclip.preprocess(jnp.asarray(u8), size=size))
    got = clip_vit.preprocess(torch.from_numpy(u8), size=size).numpy()
    assert got.shape == want.shape == (shape[0], size, size, 3)
    std = np.asarray(clip_vit.CLIP_STD, np.float32)
    assert np.abs((got - want) * std).max() <= 2e-5
    # normalize_only is the same normalisation of an already cropped batch
    crop = u8[:, :size, :size]
    want_n = np.asarray(jclip.normalize_only(jnp.asarray(crop)))
    np.testing.assert_allclose(clip_vit.normalize_only(torch.from_numpy(crop)).numpy(), want_n,
                               rtol=1e-6, atol=1e-6)


def _hf_state_dict(model):
    """The HF CLIPVisionModel layout of a port tower, with the position-id
    buffer and the unused keys of a full CLIPModel file."""
    sd = {f"vision_model.{k}": v.clone() for k, v in model.state_dict().items()}
    sd["vision_model.embeddings.position_ids"] = torch.arange(TINY.num_tokens)[None]
    return sd


def test_converters_agree_with_jax_importer():
    """One HF state dict through the JAX from_hf_state_dict and then
    clip_from_jax_params, and through clip_from_hf_state_dict: equal state
    dicts, key for key, bit for bit; both hold every key of the tower."""
    model = clip_vit.init(TINY, generator=torch.Generator().manual_seed(5))
    hf = _hf_state_dict(model)
    via_jax = clip_from_jax_params(
        jax.tree.map(np.asarray, jclip.from_hf_state_dict(hf, jax_config.CLIP_TINY)), TINY)
    direct = torch_import.clip_from_hf_state_dict(hf, TINY)
    assert set(via_jax) == set(direct) == set(model.state_dict())
    for k in direct:
        assert torch.equal(via_jax[k], direct[k]), k
        assert torch.equal(direct[k], model.state_dict()[k]), k
    assert clip_vit.from_hf_state_dict(hf, TINY).keys() == direct.keys()


def test_hf_reader_keys():
    """A full CLIPModel file's text tower, projections and logit scale are
    accepted by name and not read; an unknown key, a missing key and a key of
    another shape raise with the key's name; a JAX tree with a leaf the
    converter does not read raises."""
    model = clip_vit.init(TINY, generator=torch.Generator().manual_seed(6))
    hf = _hf_state_dict(model)
    full = {**hf, "text_model.embeddings.token_embedding.weight": torch.zeros(8, 4),
            "visual_projection.weight": torch.zeros(4, 32),
            "text_projection.weight": torch.zeros(4, 4), "logit_scale": torch.tensor(2.0)}
    assert torch_import.clip_from_hf_state_dict(full, TINY).keys() == model.state_dict().keys()
    with pytest.raises(KeyError, match="vision_model.encoder.layers.0.extra"):
        torch_import.clip_from_hf_state_dict(
            {**hf, "vision_model.encoder.layers.0.extra": torch.zeros(1)}, TINY)
    with pytest.raises(KeyError, match="unrecognised"):
        torch_import.clip_from_hf_state_dict({**hf, "pooler.weight": torch.zeros(1)}, TINY)
    del hf["vision_model.post_layernorm.bias"]
    with pytest.raises(KeyError, match="post_layernorm.bias"):
        torch_import.clip_from_hf_state_dict(hf, TINY)
    hf["vision_model.post_layernorm.bias"] = torch.zeros(16)
    with pytest.raises(ValueError, match="post_layernorm.bias"):
        torch_import.clip_from_hf_state_dict(hf, TINY)
    params = jax.tree.map(np.asarray, jclip.init(jax.random.PRNGKey(0), jax_config.CLIP_TINY))
    params["extra"] = np.zeros(1, np.float32)
    with pytest.raises(KeyError, match="extra"):
        clip_from_jax_params(params, TINY)


def test_hf_parity_and_directory_without_transformers(tmp_path, monkeypatch):
    """The port's features (fp32, no ln_post) within 2e-4 of a tiny HF
    CLIPVisionModel's last_hidden_state, as the JAX test holds its own; its
    save_pretrained directory read back by load_hf_state_dict with
    transformers made unimportable gives the same tower."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.CLIPVisionConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=128,
        image_size=32, patch_size=16, hidden_act="quick_gelu")
    torch.manual_seed(0)
    hf_model = transformers.CLIPVisionModel(hf_cfg).eval()
    model = clip_vit.CLIPVisionTower(TINY)
    model.load_state_dict(torch_import.clip_from_hf_state_dict(hf_model.state_dict(), TINY))
    imgs = np.random.RandomState(2).randn(2, 32, 32, 3).astype(np.float32)
    with torch.no_grad():
        ref = hf_model(pixel_values=torch.from_numpy(imgs.transpose(0, 3, 1, 2))).last_hidden_state
        got = clip_vit.features(model, torch.from_numpy(imgs), TINY, policy=FP32_POLICY,
                                apply_ln_post=False)
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-4)

    hf_model.save_pretrained(str(tmp_path / "clip"))
    monkeypatch.setitem(__import__("sys").modules, "transformers", None)
    sd = torch_import.load_hf_state_dict(str(tmp_path / "clip"))
    again = torch_import.clip_from_hf_state_dict(sd, TINY)
    for k, v in model.state_dict().items():
        assert torch.equal(again[k], v), k
