"""The port's caption model (prefix bridges) and gated cross-attention decoder
against the JAX ones: weights carried over by ckpt/convert, the same inputs
made from a seed with numpy, logits and loss; the trainable and decay masks
leaf for leaf."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt2_vision_language_tpu.core import config as jcfg
from gpt2_vision_language_tpu.core.precision import DEFAULT_POLICY as JAX_BF16
from gpt2_vision_language_tpu.core.precision import FP32_POLICY as JAX_FP32
from gpt2_vision_language_tpu.models import caption as jcaption
from gpt2_vision_language_tpu.models import gpt2 as jgpt2
from gpt2_vision_language_tpu_torch.ckpt.convert import (
    caption_from_jax_params, gpt2_from_jax_params,
)
from gpt2_vision_language_tpu_torch.core.config import BridgeConfig, GPTConfig
from gpt2_vision_language_tpu_torch.core.precision import DEFAULT_POLICY, FP32_POLICY
from gpt2_vision_language_tpu_torch.models import bridges, caption, gpt2
from torch_threads import share_cores  # noqa: F401  (autouse)

ARCH = dict(block_size=64, vocab_size=300, n_layer=2, n_head=2, n_embd=32)
XARCH = dict(ARCH, img_embd=24, cross_attention=True)
BKW = dict(enc_dim=24, n_queries=8, n_layers=2, n_heads=2)
B, T = 3, 16


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, ARCH["vocab_size"], (B, T)).astype(np.int32)
    y = rng.randint(0, ARCH["vocab_size"], (B, T)).astype(np.int32)
    mask = np.arange(T)[None, :] < rng.randint(3, T, (B, 1))
    z = rng.randn(B, 33, 24).astype(np.float32)
    return x, y, mask, z


def _caption_pair(kind):
    jc, pc = jcfg.GPTConfig(**ARCH), GPTConfig(**ARCH)
    jb, pb = jcfg.BridgeConfig(kind=kind, **BKW), BridgeConfig(kind=kind, **BKW)
    params = {"gpt": jgpt2.init(jax.random.PRNGKey(0), jc),
              "bridge": jcaption.init(jax.random.PRNGKey(1), jc, jb)}
    model = caption.CaptionModel(gpt2.GPT2(pc), bridges.bridge_init(pb, pc.n_embd))
    model.load_state_dict(caption_from_jax_params(jax.device_get(params), pc, pb))
    return params, jc, jb, model, pc, pb


@pytest.mark.parametrize("kind", ["linear", "qformer"])
def test_caption_apply_and_loss_match_jax_fp32(kind):
    """Logits over [prefix, text], the CE of apply and the fused-CE loss, fp32:
    logits within 1e-4 (two layers of fp32 sums in another order), losses 1e-5."""
    params, jc, jb, model, pc, pb = _caption_pair(kind)
    x, y, mask, z = _batch()
    labels = np.where(mask, y, -100).astype(np.int32)
    jl, jloss = jcaption.apply(params["gpt"], params["bridge"], jnp.asarray(z), jnp.asarray(x),
                               jc, jb, labels=jnp.asarray(labels), policy=JAX_FP32)
    jfused = jcaption.loss(params["gpt"], params["bridge"], jnp.asarray(z), jnp.asarray(x), jc,
                           jb, labels=jnp.asarray(labels), policy=JAX_FP32)
    tx, tl, tz = torch.from_numpy(x), torch.from_numpy(labels), torch.from_numpy(z)
    with torch.no_grad():
        logits, loss = caption.apply(model, tz, tx, pc, pb, labels=tl, policy=FP32_POLICY)
        fused = caption.loss(model, tz, tx, pc, pb, labels=tl, policy=FP32_POLICY)
    m = 33 if kind == "linear" else 8
    assert tuple(logits.shape) == (B, m + T, pc.padded_vocab_size) == tuple(jl.shape)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    assert float(fused) == pytest.approx(float(jfused), rel=1e-5)
    assert float(fused) == pytest.approx(float(loss), rel=1e-5)


@pytest.mark.parametrize("kind", ["linear", "qformer"])
def test_caption_loss_fn_matches_jax_bf16(kind):
    """loss_fn_factory's loss_fn on a micro-batch (y masked to -100 outside the
    caption) under the bf16 policy on both sides, tol 2e-2."""
    params, jc, jb, model, pc, pb = _caption_pair(kind)
    x, y, mask, z = _batch(1)
    jfn = jcaption.loss_fn_factory(jc, jb, policy=JAX_BF16, train=True)
    want = float(jfn(params, {"x": jnp.asarray(x), "y": jnp.asarray(y),
                              "mask": jnp.asarray(mask), "z": jnp.asarray(z)}))
    fn = caption.loss_fn_factory(pc, pb, policy=DEFAULT_POLICY, train=True)
    micro = {"x": torch.from_numpy(x), "y": torch.from_numpy(y), "mask": torch.from_numpy(mask),
             "z": torch.from_numpy(z)}
    got = float(fn(model, micro).detach())
    assert got == pytest.approx(want, abs=2e-2)
    # the unfused route is the same loss
    unfused = caption.loss_fn_factory(pc, pb, policy=DEFAULT_POLICY, fused_ce=False)
    assert float(unfused(model, micro).detach()) == pytest.approx(got, abs=2e-2)


def test_caption_loss_ignores_rows_outside_the_caption():
    """Rows with -100 contribute neither loss nor count: changing their y
    changes nothing; an all-masked batch gives 0, not NaN."""
    params, jc, jb, model, pc, pb = _caption_pair("linear")
    x, y, mask, z = _batch(2)
    fn = caption.loss_fn_factory(pc, pb, policy=FP32_POLICY)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    base = fn(model, {"x": t(x), "y": t(y), "mask": t(mask), "z": t(z)})
    y2 = np.where(mask, y, (y + 7) % ARCH["vocab_size"]).astype(np.int32)
    assert torch.equal(fn(model, {"x": t(x), "y": t(y2), "mask": t(mask), "z": t(z)}), base)
    none = fn(model, {"x": t(x), "y": t(y), "mask": t(np.zeros_like(mask)), "z": t(z)})
    assert float(none.detach()) == 0.0


def test_caption_prefix_has_no_positions_and_must_fit():
    params, jc, jb, model, pc, pb = _caption_pair("linear")
    x, _, _, z = _batch(3)
    with pytest.raises(ValueError, match="block_size"):
        caption.apply(model, torch.from_numpy(z), torch.zeros(B, 40, dtype=torch.long), pc, pb)
    # a 2-D feature is one visual token; use_cls_only keeps the first
    one = caption.embed_visual(model.bridge, torch.from_numpy(z[:, 0]), pb, policy=FP32_POLICY)
    assert tuple(one.shape) == (B, 1, pc.n_embd)
    import dataclasses
    cls = caption.embed_visual(model.bridge, torch.from_numpy(z),
                               dataclasses.replace(pb, use_cls_only=True), policy=FP32_POLICY)
    assert torch.allclose(cls, one, atol=1e-6)


def _xattn_pair(gate=0.5):
    jc, pc = jcfg.GPTConfig(**XARCH), GPTConfig(**XARCH)
    params = jgpt2.init(jax.random.PRNGKey(0), jc)
    # open the gates (init 0 would hide the whole cross-attention path) and give
    # ln_x a non-identity scale
    params["blocks"]["gate"] = jnp.full((jc.n_layer,), gate) * jnp.asarray([1.0, -0.6])
    params["blocks"]["lnx"]["scale"] = params["blocks"]["lnx"]["scale"] * 1.3
    model = gpt2.GPT2(pc)
    model.load_state_dict(gpt2_from_jax_params(jax.device_get(params), pc))
    return params, jc, model, pc


def test_xattn_apply_and_loss_match_jax_fp32():
    params, jc, model, pc = _xattn_pair()
    x, y, mask, z = _batch(4)
    jl, jloss = jgpt2.apply(params, jnp.asarray(x), jc, targets=jnp.asarray(y),
                            target_mask=jnp.asarray(mask), z=jnp.asarray(z), policy=JAX_FP32)
    jfused = jgpt2.loss(params, jnp.asarray(x), jc, targets=jnp.asarray(y),
                        target_mask=jnp.asarray(mask), z=jnp.asarray(z), policy=JAX_FP32)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    with torch.no_grad():
        logits, loss = gpt2.apply(model, t(x), pc, targets=t(y), target_mask=t(mask), z=t(z),
                                  policy=FP32_POLICY)
        fused = gpt2.loss(model, t(x), pc, targets=t(y), target_mask=t(mask), z=t(z),
                          policy=FP32_POLICY)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    assert float(fused) == pytest.approx(float(jfused), rel=1e-5)
    # z matters with open gates, and not at all without it
    with torch.no_grad():
        no_z, _ = gpt2.apply(model, t(x), pc, policy=FP32_POLICY)
    assert float((no_z - logits).abs().max()) > 1e-3


def test_xattn_matches_jax_bf16_and_gate_keeps_the_residual_dtype():
    params, jc, model, pc = _xattn_pair()
    x, y, mask, z = _batch(5)
    want = float(jgpt2.loss(params, jnp.asarray(x), jc, targets=jnp.asarray(y),
                            target_mask=jnp.asarray(mask), z=jnp.asarray(z), policy=JAX_BF16))
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    got = float(gpt2.loss(model, t(x), pc, targets=t(y), target_mask=t(mask), z=t(z),
                          policy=DEFAULT_POLICY).detach())
    assert got == pytest.approx(want, abs=2e-2)
    h = torch.randn(B, T, pc.n_embd, generator=torch.Generator().manual_seed(0)).bfloat16()
    zp = gpt2.project_visual(model, t(z), pc, torch.bfloat16)
    out = gpt2.block(model.transformer.h[0], h, pc, policy=DEFAULT_POLICY, attn_impl="auto", z=zp)
    assert out.dtype == torch.bfloat16  # the fp32 gate did not promote it


def test_xattn_starts_as_plain_gpt2_and_first_step_moves_the_gate():
    """Gates at 0: the logits are the plain decoder's whatever z is, every
    xattn leaf but the gates has a zero gradient, and the gates' is not zero
    (tanh'(0) = 1)."""
    pc = GPTConfig(**XARCH)
    model = gpt2.init(pc, generator=torch.Generator().manual_seed(0))
    x, y, mask, z = _batch(6)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    with_z, _ = gpt2.apply(model, t(x), pc, z=t(z), policy=FP32_POLICY)
    without, _ = gpt2.apply(model, t(x), pc, policy=FP32_POLICY)
    assert torch.equal(with_z, without)
    gpt2.loss(model, t(x), pc, targets=t(y), target_mask=t(mask), z=t(z),
              policy=FP32_POLICY).backward()
    for n, p in gpt2.named_params(model).items():
        if n.endswith("cross_gate"):
            assert float(p.grad.abs().max()) > 0, n
        elif ".xattn." in n or "vis_proj" in n:
            assert p.grad is None or not p.grad.any(), n


def test_masks_match_jax_leaf_for_leaf():
    """trainable_mask_xattn and decay_mask against the JAX masks, mapped
    through the converter: ln_x frozen although it sits in the trained
    prologue, the gates trained and undecayed."""
    params, jc, model, pc = _xattn_pair()
    as_tree = lambda mask: jax.tree.map(  # noqa: E731
        lambda m, p: np.full(np.shape(p), float(m), np.float32), mask, params)
    for ours, theirs in ((gpt2.trainable_mask_xattn(model), jgpt2.trainable_mask_xattn(params)),
                         (gpt2.decay_mask(model), jgpt2.decay_mask(params))):
        want = gpt2_from_jax_params(as_tree(theirs), pc)
        del want["lm_head.weight"]
        assert set(ours) == set(want) == set(gpt2.named_params(model))
        for n, m in ours.items():
            assert bool(want[n].flatten()[0]) == bool(m), n
    tm, dm = gpt2.trainable_mask_xattn(model), gpt2.decay_mask(model)
    assert not tm["transformer.h.0.ln_x.weight"] and tm["transformer.h.1.cross_gate"]
    assert tm["transformer.vis_proj.z_proj.bias"] and not tm["transformer.wte.weight"]
    assert not dm["transformer.h.0.cross_gate"] and dm["transformer.h.0.xattn.kv_proj.weight"]
    assert sum(tm.values()) == 2 + pc.n_layer * 7


def test_xattn_converter_round_trip():
    """gpt2_from_jax_params carries lnx, xattn, gate and vis_proj under the
    names ckpt/torch_import.py reads, and that importer gives the tree back."""
    from gpt2_vision_language_tpu.ckpt.torch_import import gpt2_from_torch_state_dict

    params, jc, model, pc = _xattn_pair()
    sd = gpt2_from_jax_params(jax.device_get(params), pc)
    back = gpt2_from_torch_state_dict(sd, jc)
    for (pa, a), (pb_, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                 jax.tree_util.tree_leaves_with_path(params)):
        assert pa == pb_
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(pa))
