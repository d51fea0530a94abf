"""AdamW, the LR schedule and the decay mask of the PyTorch port against the
JAX package: the plain AdamW leaf update against the JAX Pallas kernel
(interpret mode), adamw_update against the JAX adamw_update over a small
GPT-2, freezing, and the schedule. The CUDA kernel itself is checked against
the plain version on the card by chip_smoke.py."""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpt2_vision_language_tpu.ops.fused_adamw as jfw
from gpt2_vision_language_tpu.core import config as jcfg
from gpt2_vision_language_tpu.models import gpt2 as jgpt2
from gpt2_vision_language_tpu.train import optimizer as jopt
from gpt2_vision_language_tpu.train import schedule as jsched
from gpt2_vision_language_tpu_torch.ckpt.convert import gpt2_from_jax_params, opt_state_from_jax
from gpt2_vision_language_tpu_torch.core.config import GPTConfig, OptimizerConfig, ScheduleConfig
from gpt2_vision_language_tpu_torch.models import gpt2
from gpt2_vision_language_tpu_torch.ops import fused_adamw as fw
from gpt2_vision_language_tpu_torch.train import optimizer, schedule
from torch_threads import share_cores  # noqa: F401  (autouse)

CFG = GPTConfig(block_size=64, vocab_size=300, n_layer=2, n_head=2, n_embd=64)
JCFG = jcfg.GPTConfig(block_size=64, vocab_size=300, n_layer=2, n_head=2, n_embd=64)


@pytest.mark.parametrize("step", [0, 1, 714, 715, 10000, 19073, 20000])
def test_cosine_warmup_lr_matches_jax(step):
    want = float(jsched.cosine_warmup_lr(step, jcfg.ScheduleConfig()))
    assert schedule.cosine_warmup_lr(step, ScheduleConfig()) == pytest.approx(want, rel=1e-6)


def _adamw_fp64(p, g, m, v, scal, wd):
    """The AdamW leaf formula in fp64 on the fp32 inputs: (p, m, v)."""
    p, g, m, v = (a.astype(np.float64) for a in (p, g, m, v))
    lr, b1, b2, eps, clip_scale, bc1, bc2 = scal.astype(np.float64)
    g = g * clip_scale
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    if wd:
        p = p * (1 - lr * wd)
    return p - lr * (m / bc1) / (np.sqrt(v / bc2) + eps), m, v


@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_adamw_reference_matches_jax_kernel(wd):
    """One fp32 leaf of 8 x 128 rows x 3: p, m, v of the port's plain AdamW
    and of fused_adamw_leaf in interpret mode, each within rtol 5e-7 / atol
    5e-8 of an fp64 evaluation of the same formula, so within 1e-6 / 1e-7 of
    each other. Both read about 0.2 of that limit; holding each side to the
    fp64 value, and not one to the other, names the side that is off should
    this ever fail (it did once, unexplained, in a run under load)."""
    rng = np.random.RandomState(0)
    p, g, m = (rng.randn(3 * 1024).astype(np.float32) for _ in range(3))
    v = rng.rand(3 * 1024).astype(np.float32)
    scal = np.array([1e-3, 0.9, 0.95, 1e-8, 0.7, 1 - 0.9**3, 1 - 0.95**3], np.float32)
    truth = _adamw_fp64(p, g, m, v, scal, wd)
    interp = functools.partial(jfw.pl.pallas_call, interpret=True)
    with mock.patch.object(jfw.pl, "pallas_call", interp):
        # copies: the kernel aliases p, m, v to its outputs
        want = jfw.fused_adamw_leaf(*(jnp.array(a) for a in (p, g, m, v, scal)), wd=wd)
    got = [torch.from_numpy(a.copy()) for a in (p, g, m, v)]
    fw.fused_adamw([tuple(got)], torch.from_numpy(scal.copy()), [wd])
    assert fw.fused_adamw.launches == 0  # CPU tensors: the plain version
    for name, a, w, t in zip("pmv", (got[0], got[2], got[3]), want, truth):
        np.testing.assert_allclose(a.numpy(), t, rtol=5e-7, atol=5e-8,
                                   err_msg=f"port {name}")
        np.testing.assert_allclose(np.asarray(w), t, rtol=5e-7, atol=5e-8,
                                   err_msg=f"JAX kernel {name}")


def _jax_setup(scale):
    """A small JAX GPT-2, random grads (times `scale`) and moments at step 5."""
    params = jgpt2.init(jax.random.PRNGKey(0), JCFG)
    rng = np.random.RandomState(1)
    rand = lambda pos=False: jax.tree.map(  # noqa: E731
        lambda a: jnp.asarray((rng.rand(*a.shape) if pos else rng.randn(*a.shape))
                              .astype(np.float32)), params)
    grads = jax.tree.map(lambda a: a * scale, rand())
    state = {"m": jax.tree.map(lambda a: a * 1e-2, rand()),
             "v": jax.tree.map(lambda a: a * 1e-4, rand(pos=True)),
             "step": jnp.int32(5)}
    return params, grads, state


def _port_setup(params, grads, state):
    model = gpt2.GPT2(CFG)
    model.load_state_dict(gpt2_from_jax_params(jax.device_get(params), CFG))
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    g = gpt2_from_jax_params(np_tree(grads), CFG)
    del g["lm_head.weight"]
    return model, g, opt_state_from_jax(np_tree(state), CFG)


@pytest.mark.parametrize("scale, grad_scale", [(1.0, None), (1e-4, None), (1.0, 0.5)],
                         ids=["clipped", "unclipped", "grad_scale"])
def test_adamw_update_matches_jax(scale, grad_scale):
    """Params, moments and the norm after one update of a small GPT-2 with
    the decay mask, against the JAX adamw_update (fp32, within 1e-6)."""
    params, grads, state = _jax_setup(scale)
    want_p, want_s, want_norm = jopt.adamw_update(
        params, grads, state, jnp.float32(1e-3), jcfg.OptimizerConfig(),
        decay_mask=jgpt2.decay_mask(params),
        grad_scale=None if grad_scale is None else jnp.float32(grad_scale))
    model, g, st = _port_setup(params, grads, state)
    p = gpt2.named_params(model)
    norm = optimizer.global_norm(g) * (1.0 if grad_scale is None else grad_scale)
    optimizer.adamw_update(p, g, st, 1e-3, OptimizerConfig(), norm=norm,
                           decay_mask=gpt2.decay_mask(model), grad_scale=grad_scale)
    assert (float(want_norm) > 1.0) == (scale == 1.0)  # the clip is active or not
    np.testing.assert_allclose(norm.item(), float(want_norm), rtol=1e-6)
    assert st["step"] == 6
    want_p = gpt2_from_jax_params(jax.device_get(want_p), CFG)
    want_st = opt_state_from_jax(jax.tree.map(np.asarray, want_s), CFG)
    for n, a in p.items():
        np.testing.assert_allclose(a.detach().numpy(), want_p[n].numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=n)
        for key in ("m", "v"):
            np.testing.assert_allclose(st[key][n].numpy(), want_st[key][n].numpy(),
                                       rtol=1e-5, atol=1e-9, err_msg=f"{key} {n}")


def test_frozen_leaves_unchanged():
    """Under a trainable mask the frozen leaves keep their values, get no
    moments, and stay out of the masked global norm."""
    params, grads, state = _jax_setup(1.0)
    model, g, _ = _port_setup(params, grads, state)
    p = gpt2.named_params(model)
    tmask = {n: n.startswith("transformer.h.1.") for n in p}
    before = {n: a.detach().clone() for n, a in p.items()}
    st = optimizer.adamw_init(p, trainable_mask=tmask)
    assert set(st["m"]) == {n for n in p if tmask[n]}
    norm = optimizer.global_norm(g, tmask)
    want_norm = optimizer.global_norm({n: g[n] for n in p if tmask[n]})
    assert norm.item() == pytest.approx(want_norm.item(), rel=1e-6)
    assert norm.item() < optimizer.global_norm(g).item()
    optimizer.adamw_update(p, g, st, 1e-3, OptimizerConfig(), norm=norm,
                           decay_mask=gpt2.decay_mask(model), trainable_mask=tmask)
    for n, a in p.items():
        assert torch.equal(a, before[n]) != tmask[n], n
    optimizer.freeze(model, tmask)
    assert all(a.requires_grad == tmask[n] for n, a in p.items())


def test_decay_mask_matches_jax():
    params = jgpt2.init(jax.random.PRNGKey(0), JCFG)
    # the JAX mask has one bool per stacked leaf: spread it over the leaf
    want = gpt2_from_jax_params(
        jax.tree.map(lambda m, p: np.full(p.shape, m, np.float32),
                     jgpt2.decay_mask(params), params), CFG)
    got = gpt2.decay_mask(gpt2.GPT2(CFG))
    assert set(got) == set(want) - {"lm_head.weight"}
    assert {n: bool(want[n].flatten()[0]) for n in got} == got
    assert got["transformer.wte.weight"] and not got["transformer.h.0.ln_1.weight"]


def test_fused_adamw_refuses():
    p = torch.zeros(4)
    with pytest.raises(ValueError):
        fw.fused_adamw([(p, p, p, torch.zeros(5))], torch.zeros(7), [0.0])
    with pytest.raises(ValueError):
        fw.fused_adamw([(p, p, p, p)], torch.zeros(7), [0.0, 0.1])
