"""The PyTorch port's train step against the JAX make_train_step: the same
params and batches, 3 optimizer steps at fp32, then the NaN guard and a
falling loss on a fixed batch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt2_vision_language_tpu.core import config as jcfg
from gpt2_vision_language_tpu.core.precision import FP32_POLICY as JAX_FP32
from gpt2_vision_language_tpu.models import gpt2 as jgpt2
from gpt2_vision_language_tpu.train import make_train_step as jax_make_train_step
from gpt2_vision_language_tpu.train.optimizer import adamw_init as jax_adamw_init
from gpt2_vision_language_tpu_torch.ckpt.convert import gpt2_from_jax_params
from gpt2_vision_language_tpu_torch.core.config import GPTConfig, OptimizerConfig, ScheduleConfig
from gpt2_vision_language_tpu_torch.core.precision import FP32_POLICY
from gpt2_vision_language_tpu_torch.models import gpt2
from gpt2_vision_language_tpu_torch.ops import flash_attention as fa
from gpt2_vision_language_tpu_torch.ops import fused_adamw as fw
from gpt2_vision_language_tpu_torch.train.optimizer import adamw_init
from gpt2_vision_language_tpu_torch.train.step import make_train_step
from torch_threads import share_cores  # noqa: F401  (autouse)

ARCH = dict(block_size=256, vocab_size=500, n_layer=2, n_head=2, n_embd=128)
SCHED = dict(max_lr=1e-3, min_lr=1e-4, warmup_steps=2, max_steps=10)
# Adam's first steps divide each grad by its own magnitude: with the
# reference's eps=1e-8, grads of ~1e-8 (wte rows of tokens absent from the
# batch) that differ by fp32 sum order (~3e-9) move their params by ~2e-5.
# eps=1e-6 keeps the parameter check about the port's arithmetic.
OPT = dict(eps=1e-6)


def _rows(seed, accum, b, t, vocab):
    return np.random.RandomState(seed).randint(0, vocab, (accum, b, t + 1)).astype(np.int32)


def _port_loss(cfg, attn_impl):
    def loss_fn(model, micro):
        rows = micro["rows"]
        loss = gpt2.loss(model, rows[:, :-1], cfg, targets=rows[:, 1:],
                         policy=FP32_POLICY, attn_impl=attn_impl)
        return loss * micro["scale"]
    return loss_fn


def test_three_steps_match_jax():
    """accum=2, B=2, T=128: loss and grad norm within 1e-5 relative and
    post-update params within 1e-5 of the JAX step at every step. The port
    runs attention through the flash Function (its plain versions on the
    CPU) and the AdamW wrapper; JAX runs its einsum attention."""
    jc, pc = jcfg.GPTConfig(**ARCH), GPTConfig(**ARCH)
    params = jgpt2.init(jax.random.PRNGKey(0), jc)
    jstate = jax_adamw_init(params)

    def jloss(p, micro):
        rows = micro["rows"]
        return jgpt2.loss(p, rows[:, :-1], jc, targets=rows[:, 1:], policy=JAX_FP32,
                          attn_impl="xla")

    jstep = jax_make_train_step(jloss, jcfg.OptimizerConfig(**OPT), jcfg.ScheduleConfig(**SCHED),
                                decay_mask=jgpt2.decay_mask(params), donate=False)
    model = gpt2.GPT2(pc)
    model.load_state_dict(gpt2_from_jax_params(jax.device_get(params), pc))
    state = adamw_init(gpt2.named_params(model))
    step = make_train_step(_port_loss(pc, "flash"), OptimizerConfig(**OPT), ScheduleConfig(**SCHED),
                           decay_mask=gpt2.decay_mask(model))
    for i in range(3):
        rows = _rows(i, 2, 2, 128, pc.vocab_size)
        params, jstate, jm = jstep(params, jstate, {"rows": jnp.asarray(rows)}, jnp.int32(i))
        m = step(model, state, {"rows": torch.from_numpy(rows), "scale": torch.ones(2)}, i)
        for key in ("loss", "grad_norm", "lr"):
            assert m[key] == pytest.approx(float(jm[key]), rel=1e-5), (i, key)
        want = gpt2_from_jax_params(jax.device_get(params), pc)
        for n, p in gpt2.named_params(model).items():
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=f"step {i} {n}")
    assert state["step"] == 3 == int(jstate["step"])
    assert fa.flash_attention.launches == fa.flash_attention_backward.launches == 0
    assert fw.fused_adamw.launches == 0


SMALL = GPTConfig(block_size=32, vocab_size=128, n_layer=2, n_head=2, n_embd=32)


def _small(seed=0):
    model = gpt2.init(SMALL, generator=torch.Generator().manual_seed(seed))
    step = make_train_step(_port_loss(SMALL, "auto"), OptimizerConfig(),
                           ScheduleConfig(**SCHED), decay_mask=gpt2.decay_mask(model))
    batch = {"rows": torch.from_numpy(_rows(0, 2, 4, 16, SMALL.vocab_size)),
             "scale": torch.ones(2)}
    return model, adamw_init(gpt2.named_params(model)), step, batch


def test_nan_guard_skips_the_update():
    """A poisoned batch (non-finite loss) leaves params and moments as they
    were and reports the non-finite loss."""
    model, state, step, batch = _small()
    step(model, state, batch, 0)
    before = {n: p.detach().clone() for n, p in gpt2.named_params(model).items()}
    m_before = {n: a.clone() for n, a in state["m"].items()}
    poisoned = dict(batch, scale=torch.tensor([1.0, float("nan")]))
    m = step(model, state, poisoned, 1)
    assert not np.isfinite(m["loss"])
    assert state["step"] == 1
    for n, p in gpt2.named_params(model).items():
        assert torch.equal(p, before[n]) and torch.equal(state["m"][n], m_before[n]), n


def test_loss_decreases():
    """A fixed batch: the loss must fall by more than 0.2 in 10 steps
    (tests/test_train_step.py:40)."""
    model, state, step, batch = _small()
    losses = [step(model, state, batch, i)["loss"] for i in range(10)]
    assert losses[-1] < losses[0] - 0.2, losses
