"""The port's linear and Q-Former bridges against the JAX ones: the JAX
parameters carried over by ckpt/convert.bridge_from_jax_params, the same
inputs made from a seed with numpy, forward and gradients; the dropout's
properties; the decay mask leaf for leaf."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt2_vision_language_tpu.core import config as jcfg
from gpt2_vision_language_tpu.core.precision import DEFAULT_POLICY as JAX_BF16
from gpt2_vision_language_tpu.core.precision import FP32_POLICY as JAX_FP32
from gpt2_vision_language_tpu.models import bridges as jbridges
from gpt2_vision_language_tpu_torch.ckpt.convert import bridge_from_jax_params
from gpt2_vision_language_tpu_torch.core.config import BridgeConfig
from gpt2_vision_language_tpu_torch.core.precision import DEFAULT_POLICY, FP32_POLICY
from gpt2_vision_language_tpu_torch.models import bridges
from torch_threads import share_cores  # noqa: F401  (autouse)

D_LM = 32
KW = dict(enc_dim=24, n_queries=8, n_layers=2, n_heads=2)


def _pair(kind, seed=0):
    """(JAX params, JAX cfg, port module with the same weights, port cfg)."""
    jc, pc = jcfg.BridgeConfig(kind=kind, **KW), BridgeConfig(kind=kind, **KW)
    params = jbridges.bridge_init(jax.random.PRNGKey(seed), jc, D_LM)
    if kind == "qformer":
        # torch's zero-initialised biases would hide a mis-ordered bias split
        rng = np.random.RandomState(1)
        for attn in ("self_attn", "cross_attn"):
            for b in ("bq", "bk", "bv", "bo"):
                leaf = params["layers"][attn][b]
                params["layers"][attn][b] = jnp.asarray(
                    rng.randn(*leaf.shape).astype(np.float32) * 0.1)
    mod = bridges.bridge_init(pc, D_LM)
    mod.load_state_dict(bridge_from_jax_params(jax.device_get(params), pc))
    return params, jc, mod, pc


def _tokens(seed=0, b=3, n=33):
    return np.random.RandomState(seed).randn(b, n, KW["enc_dim"]).astype(np.float32)


@pytest.mark.parametrize("kind", ["linear", "qformer"])
def test_forward_matches_jax_fp32(kind):
    """Outputs, not shapes: a transposed or mis-ordered q/k/v split of the
    packed in-projection passes every shape check. fp32, tol 1e-5."""
    params, jc, mod, pc = _pair(kind)
    x = _tokens()
    want = np.asarray(jbridges.bridge_apply(params, jnp.asarray(x), jc, policy=JAX_FP32))
    got = bridges.bridge_apply(mod, torch.from_numpy(x), pc, policy=FP32_POLICY)
    assert got.shape == want.shape == (3, 33 if kind == "linear" else 8, D_LM)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kind", ["linear", "qformer"])
def test_forward_matches_jax_bf16(kind):
    """bf16 policy on both sides: operands round at the same places, tol 2e-2."""
    params, jc, mod, pc = _pair(kind)
    x = _tokens(1)
    want = np.asarray(jbridges.bridge_apply(params, jnp.asarray(x), jc, policy=JAX_BF16),
                      np.float32)
    got = bridges.bridge_apply(mod, torch.from_numpy(x), pc, policy=DEFAULT_POLICY)
    np.testing.assert_allclose(got.detach().float().numpy(), want, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("kind", ["linear", "qformer"])
def test_gradients_match_jax_fp32(kind):
    """d(sum(out * w)) / d(params) through the converter's mapping, fp32,
    tol 1e-5 relative to each leaf's largest gradient."""
    params, jc, mod, pc = _pair(kind)
    x = _tokens(2)
    w = np.random.RandomState(3).randn(3, 33 if kind == "linear" else 8, D_LM).astype(np.float32)

    def jloss(p):
        return jnp.sum(jbridges.bridge_apply(p, jnp.asarray(x), jc, policy=JAX_FP32) * w)

    jgrads = jax.device_get(jax.grad(jloss)(params))
    out = bridges.bridge_apply(mod, torch.from_numpy(x), pc, policy=FP32_POLICY)
    (out * torch.from_numpy(w)).sum().backward()
    want = bridge_from_jax_params(jgrads, pc)
    got = {n: p.grad for n, p in mod.named_parameters()}
    assert set(got) == set(want)
    for n, g in want.items():
        scale = max(float(g.abs().max()), 1e-6)
        assert float((got[n] - g).abs().max()) <= 1e-5 * max(scale, 1.0), n


def test_decay_mask_matches_jax_leaf_for_leaf():
    for kind in ("linear", "qformer"):
        params, jc, mod, pc = _pair(kind)
        jmask = jax.tree.map(lambda m, p: np.full(np.shape(p), float(m), np.float32),
                             jbridges.bridge_decay_mask(params), params)
        want = bridge_from_jax_params(jmask, pc)
        got = bridges.bridge_decay_mask(mod)
        assert set(got) == set(want) == set(dict(mod.named_parameters()))
        for n, m in got.items():
            assert bool(want[n].flatten()[0]) == m and len(want[n].unique()) == 1, n
        assert got["vis_proj.weight"] and not got["vis_proj.bias"]
    assert got["query_tokens"] and got["layers.0.self_attn.in_proj_weight"]
    assert not got["layers.0.ln1.weight"] and not got["layers.1.cross_attn.in_proj_bias"]


def test_state_dict_names_are_the_reference_ones():
    """The names ckpt/torch_import.qformer_bridge_from_torch reads, and the
    round trip through it gives the JAX tree back."""
    from gpt2_vision_language_tpu.ckpt.torch_import import qformer_bridge_from_torch

    params, jc, mod, pc = _pair("qformer")
    sd = {"bridge." + k: v for k, v in mod.state_dict().items()}
    assert {"bridge.vis_proj.weight", "bridge.query_tokens",
            "bridge.layers.0.self_attn.in_proj_weight", "bridge.layers.1.cross_attn.out_proj.bias",
            "bridge.layers.0.ln2_v.weight", "bridge.layers.1.mlp.2.weight"} <= set(sd)
    back = qformer_bridge_from_torch(sd, pc.n_layers)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_init_distributions():
    """torch's defaults: Linear U(+-1/sqrt(fan_in)), in-proj Xavier uniform over
    the packed matrix, zero attention biases, unit LayerNorm, N(0, 1) queries;
    one generator seed gives one bridge."""
    cfg = BridgeConfig(kind="qformer", enc_dim=64, n_queries=32, n_layers=1, n_heads=4)
    g = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    a, b = bridges.bridge_init(cfg, 128, generator=g()), bridges.bridge_init(cfg, 128, generator=g())
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
    sd = {n: p.detach() for n, p in a.named_parameters()}
    assert float(sd["vis_proj.weight"].abs().max()) <= 1 / 8 and sd["vis_proj.weight"].std() > 0.05
    bound = (6.0 / (128 + 384)) ** 0.5
    w = sd["layers.0.self_attn.in_proj_weight"]
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.9 * bound
    assert not sd["layers.0.self_attn.in_proj_bias"].any()
    assert not sd["layers.0.cross_attn.out_proj.bias"].any()
    assert torch.equal(sd["layers.0.ln3.weight"], torch.ones(128))
    assert abs(float(sd["query_tokens"].std()) - 1.0) < 0.05
    assert float(sd["layers.0.mlp.2.bias"].abs().max()) <= (1 / 512) ** 0.5
    with pytest.raises(ValueError, match="xattn"):
        bridges.bridge_init(BridgeConfig(kind="xattn"), 32)


def test_dropout_rate_scale_and_determinism():
    x = torch.ones(200, 500)
    g = torch.Generator().manual_seed(0)
    y = bridges._dropout(x, 0.1, g, True)
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.9) < 0.01  # keep rate 1 - p
    assert torch.allclose(y[y != 0], torch.tensor(1 / 0.9))  # the 1 / (1 - p) scale
    again = bridges._dropout(x, 0.1, torch.Generator().manual_seed(0), True)
    assert torch.equal(y, again)  # one seed, one mask
    # the identity: eval mode, no generator, rate 0
    assert bridges._dropout(x, 0.1, g, False) is x
    assert bridges._dropout(x, 0.1, None, True) is x
    assert bridges._dropout(x, 0.0, g, True) is x


def test_qformer_dropout_is_training_only_and_seeded():
    params, jc, mod, pc = _pair("qformer")
    x = torch.from_numpy(_tokens(4))
    run = lambda **kw: bridges.bridge_apply(mod, x, pc, policy=FP32_POLICY, **kw)  # noqa: E731
    base = run()
    assert torch.equal(run(generator=torch.Generator().manual_seed(1), train=False), base)
    assert torch.equal(run(generator=None, train=True), base)
    a = run(generator=torch.Generator().manual_seed(1), train=True)
    b = run(generator=torch.Generator().manual_seed(1), train=True)
    c = run(generator=torch.Generator().manual_seed(2), train=True)
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, base)
    # dropout 0.0 in training is the eval forward (the parity tests' setting)
    import dataclasses
    off = dataclasses.replace(pc, dropout=0.0)
    assert torch.equal(bridges.bridge_apply(mod, x, off, policy=FP32_POLICY, train=True,
                                            generator=torch.Generator().manual_seed(1)), base)
