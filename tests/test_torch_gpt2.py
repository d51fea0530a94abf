"""The PyTorch port's GPT-2 against the JAX package, as a whole: the same
JAX-initialized weights through ckpt/convert, then logits, loss, the cached
forward, the scoring forward on both kernels' paths, and the eval step."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt2_vision_language_tpu.ckpt.torch_export import (
    gpt2_to_torch_state_dict,
    save_torch_checkpoint,
)
from gpt2_vision_language_tpu.core import precision as jp
from gpt2_vision_language_tpu.core.config import GPTConfig as JaxGPTConfig
from gpt2_vision_language_tpu.models import gpt2 as jgpt2
from gpt2_vision_language_tpu.ops import flash_attention as jfa
from gpt2_vision_language_tpu.ops import fused_ce as jce
from gpt2_vision_language_tpu.train.step import make_eval_step as jax_make_eval_step
from gpt2_vision_language_tpu_torch.ckpt.convert import gpt2_from_jax_params
from gpt2_vision_language_tpu_torch.ckpt.torch_import import (
    gpt2_from_torch_state_dict,
    load_torch_checkpoint,
)
from gpt2_vision_language_tpu_torch.core.config import GPTConfig
from gpt2_vision_language_tpu_torch.core.precision import DEFAULT_POLICY, FP32_POLICY
from gpt2_vision_language_tpu_torch.models import gpt2
from gpt2_vision_language_tpu_torch.ops import flash_attention as fa
from gpt2_vision_language_tpu_torch.ops import fused_ce as fc
from gpt2_vision_language_tpu_torch.train.step import make_eval_step
from torch_threads import share_cores  # noqa: F401  (autouse)

KW = dict(block_size=256, vocab_size=500, n_layer=2, n_head=2, n_embd=128)
CFG, JCFG = GPTConfig(**KW), JaxGPTConfig(**KW)  # hs 64, padded V 512


@pytest.fixture(scope="module")
def jax_params():
    return jgpt2.init(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def model(jax_params):
    m = gpt2.GPT2(CFG)
    m.load_state_dict(gpt2_from_jax_params(jax.tree.map(np.asarray, jax_params), CFG))
    return m.eval()


def _tokens(b, t, seed=0):
    return np.random.RandomState(seed).randint(0, CFG.vocab_size, (b, t + 1))


def test_state_dict_matches_torch_export(jax_params, model):
    want = gpt2_to_torch_state_dict(jax_params, JCFG)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert model.lm_head.weight is model.transformer.wte.weight


def test_apply_and_loss_match_jax_fp32(jax_params, model):
    toks = _tokens(2, 64)
    idx, tgt = toks[:, :-1], toks[:, 1:]
    jlogits, jloss = jgpt2.apply(jax_params, jnp.asarray(idx), JCFG,
                                 targets=jnp.asarray(tgt), policy=jp.FP32_POLICY)
    jfused = jgpt2.loss(jax_params, jnp.asarray(idx), JCFG, targets=jnp.asarray(tgt),
                        policy=jp.FP32_POLICY)
    with torch.no_grad():
        logits, loss = gpt2.apply(model, torch.from_numpy(idx), CFG,
                                  targets=torch.from_numpy(tgt), policy=FP32_POLICY)
        fused = gpt2.loss(model, torch.from_numpy(idx), CFG,
                          targets=torch.from_numpy(tgt), policy=FP32_POLICY)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(fused.item(), float(jfused), rtol=1e-4, atol=1e-4)


def test_ignore_index_and_mask_match_jax(jax_params, model):
    toks = _tokens(2, 32, seed=1)
    idx, tgt = toks[:, :-1], toks[:, 1:].copy()
    tgt[0, :5] = -100
    mask = np.random.RandomState(2).rand(2, 32) > 0.3
    want = jgpt2.loss(jax_params, jnp.asarray(idx), JCFG, targets=jnp.asarray(tgt),
                      target_mask=jnp.asarray(mask), policy=jp.FP32_POLICY)
    with torch.no_grad():
        got = gpt2.loss(model, torch.from_numpy(idx), CFG, targets=torch.from_numpy(tgt),
                        target_mask=torch.from_numpy(mask), policy=FP32_POLICY)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4, atol=1e-4)


def test_forward_cached_matches_jax(jax_params, model):
    """Prefill 8 tokens then decode 1, fp32, within 1e-4 of JAX unroll=True."""
    ids = _tokens(2, 8, seed=3)  # 9 tokens: prefill 8, decode the 9th
    jc = jgpt2.init_cache(JCFG, 2, 16, jnp.float32)
    jemb = jgpt2.embed_tokens(jax_params, jnp.asarray(ids), JCFG)
    jl1, jc = jgpt2.forward_cached(jax_params, jemb[:, :8], JCFG, jc, jnp.int32(0),
                                   policy=jp.FP32_POLICY, unroll=True)
    jl2, _ = jgpt2.forward_cached(jax_params, jemb[:, 8:], JCFG, jc, jnp.int32(8),
                                  policy=jp.FP32_POLICY, unroll=True)
    with torch.no_grad():
        cache = gpt2.init_cache(CFG, 2, 16, torch.float32)
        emb = gpt2.embed_tokens(model, torch.from_numpy(ids), CFG)
        l1, cache = gpt2.forward_cached(model, emb[:, :8], CFG, cache, 0,
                                        policy=FP32_POLICY)
        l2, cache = gpt2.forward_cached(model, emb[:, 8:], CFG, cache, 8,
                                        policy=FP32_POLICY)
        last, _ = gpt2.forward_cached(model, emb[:, 8:], CFG,
                                      gpt2.init_cache(CFG, 2, 16, torch.float32), 0,
                                      policy=FP32_POLICY, last_only=True)
    np.testing.assert_allclose(l1.numpy(), np.asarray(jl1), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(l2.numpy(), np.asarray(jl2), rtol=1e-4, atol=1e-4)
    assert last.shape == (2, 1, CFG.padded_vocab_size)
    # slots past the written prefix stay zero
    assert not cache["k"][:, :, :, 9:].any()


def test_scoring_forward_bf16_on_both_kernels_paths(jax_params, model):
    """bf16 policy, B=2 T=128: JAX runs _fwd_dt_kernel and _ce_fwd_kernel in
    interpret mode, the port their plain versions; within 2e-2, the gap
    being where bf16 rounds in each framework."""
    toks = _tokens(2, 128, seed=4)
    idx, tgt = toks[:, :-1], toks[:, 1:]
    with mock.patch.object(jfa, "FORCE_INTERPRET", True), \
            mock.patch.object(jce, "FORCE_INTERPRET", True):
        want = jgpt2.loss(jax_params, jnp.asarray(idx), JCFG, targets=jnp.asarray(tgt),
                          policy=jp.DEFAULT_POLICY, attn_impl="flash")
    with torch.no_grad():
        got = gpt2.loss(model, torch.from_numpy(idx), CFG, targets=torch.from_numpy(tgt),
                        policy=DEFAULT_POLICY, attn_impl="flash", ce_impl="kernel")
    assert (fa.flash_attention.launches, fc.ce_forward.launches) == (0, 0)
    np.testing.assert_allclose(got.item(), float(want), rtol=2e-2, atol=2e-2)


def test_eval_step_matches_jax(jax_params, model):
    toks = np.stack([_tokens(2, 32, seed=s) for s in (5, 6, 7)])  # 3 micro-batches
    batch = {"idx": toks[..., :-1], "targets": toks[..., 1:]}
    jstep = jax_make_eval_step(lambda p, mb: jgpt2.loss(
        p, mb["idx"], JCFG, targets=mb["targets"], policy=jp.FP32_POLICY))
    want = jstep(jax_params, jax.tree.map(jnp.asarray, batch))
    step = make_eval_step(lambda m, mb: gpt2.loss(
        m, mb["idx"], CFG, targets=mb["targets"], policy=FP32_POLICY))
    got = step(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-5)


def test_reference_checkpoint_round_trip(jax_params, model, tmp_path):
    """A reference-format .pt (written by the JAX exporter, with an unpadded
    vocab and the causal-mask buffers some reference versions save) loads."""
    path = str(tmp_path / "model.pt")
    save_torch_checkpoint(path, jax_params, JCFG, meta={"step": 7})
    raw = torch.load(path, weights_only=False)
    raw["model"]["transformer.wte.weight"] = raw["model"]["transformer.wte.weight"][:500]
    raw["model"]["lm_head.weight"] = raw["model"]["transformer.wte.weight"]
    raw["model"]["transformer.h.0.attn.bias"] = torch.ones(1, 1, 8, 8)
    torch.save(raw, path)
    raw, meta = load_torch_checkpoint(path)
    sd = gpt2_from_torch_state_dict(raw, CFG)
    m = gpt2.GPT2(CFG)
    m.load_state_dict(sd)
    assert meta == {"step": 7}
    assert not m.transformer.wte.weight[500:].any()
    torch.testing.assert_close(m.transformer.wte.weight[:500],
                               model.transformer.wte.weight[:500], rtol=0, atol=0)


def test_init_distribution():
    cfg = GPTConfig(block_size=64, vocab_size=4000, n_layer=4, n_head=4, n_embd=256)
    m = gpt2.init(cfg, generator=torch.Generator().manual_seed(3))
    sd = m.state_dict()
    proj_std = 0.02 * (2 * cfg.n_layer) ** -0.5
    assert abs(sd["transformer.wte.weight"].std().item() - 0.02) < 1e-3
    assert abs(sd["transformer.h.1.attn.c_attn.weight"].std().item() - 0.02) < 1e-3
    assert abs(sd["transformer.h.1.mlp.c_proj.weight"].std().item() - proj_std) < 3e-4
    assert abs(sd["transformer.h.2.attn.c_proj.weight"].std().item() - proj_std) < 3e-4
    assert not sd["transformer.h.0.mlp.c_fc.bias"].any()
    assert torch.equal(sd["transformer.h.3.ln_2.weight"], torch.ones(256))
    assert all(v.dtype == torch.float32 for v in sd.values())


def test_refusals():
    # the gated cross-attention decoder is built now; without a visual width it raises
    with pytest.raises(ValueError, match="img_embd"):
        gpt2.GPT2(GPTConfig(n_layer=1, cross_attention=True))
    x = gpt2.GPT2(GPTConfig(block_size=8, vocab_size=100, n_layer=1, n_head=2, n_embd=16,
                            img_embd=24, cross_attention=True))
    assert "transformer.h.0.cross_gate" in dict(x.named_parameters())
    m = gpt2.GPT2(GPTConfig(block_size=8, vocab_size=100, n_layer=1, n_head=2, n_embd=16))
    with pytest.raises(ValueError, match="block_size"):
        gpt2.apply(m, torch.zeros(1, 9, dtype=torch.long), m.cfg)
