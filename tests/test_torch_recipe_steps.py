"""The big-model memory recipes of the PyTorch port in the train step,
against the JAX package: stochastic rounding of bf16 accumulators, the
explicit fp32 accumulators, the layerwise backward, the remat modes, and a
tiny `cli.pretrain` run with the whole 1558M stack, resumed. Mirrors
tests/test_bf16_drift.py and tests/test_layerwise_grad.py; the optimizer
state's recipes are in tests/test_torch_memory_recipes.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpt2_vision_language_tpu.train.optimizer as jopt
from gpt2_vision_language_tpu.core import config as jcfg
from gpt2_vision_language_tpu.core.precision import FP32_POLICY as JAX_FP32
from gpt2_vision_language_tpu.models import gpt2 as jgpt2
from gpt2_vision_language_tpu.train import make_train_step as jax_make_train_step
from gpt2_vision_language_tpu_torch.ckpt.convert import gpt2_from_jax_params
from gpt2_vision_language_tpu_torch.core.config import GPTConfig, OptimizerConfig, ScheduleConfig
from gpt2_vision_language_tpu_torch.core.precision import FP32_POLICY
from gpt2_vision_language_tpu_torch.models import gpt2
from gpt2_vision_language_tpu_torch.train import optimizer as popt
from gpt2_vision_language_tpu_torch.train.step import make_train_step, stochastic_round_bf16
from torch_threads import share_cores  # noqa: F401  (autouse)

ARCH = dict(block_size=32, vocab_size=128, n_layer=2, n_head=2, n_embd=64)

JCFG, PCFG = jcfg.GPTConfig(**ARCH), GPTConfig(**ARCH)
SCHED = dict(max_lr=1e-3, min_lr=1e-4, warmup_steps=2, max_steps=10)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_model(jparams, dtype=torch.float32):
    model = gpt2.GPT2(PCFG)
    model.load_state_dict(gpt2_from_jax_params(_np(jparams), PCFG))
    return model.to(dtype)


def _port_grads(jgrads):
    g = gpt2_from_jax_params(_np(jgrads), PCFG)
    del g["lm_head.weight"]
    return g


def _small_q8(monkeypatch, min_size=64):
    """Q8_MIN_SIZE lowered on both sides, so that the stacked LayerNorm and
    bias leaves ((2, 64)) qualify as they do at 1558M; their per-layer
    tensors (64,) alone would not."""
    monkeypatch.setattr(jopt, "Q8_MIN_SIZE", min_size)
    monkeypatch.setattr(popt, "Q8_MIN_SIZE", min_size)


# ---------------------------------------------------------------------------
# Stochastic rounding and the accumulators
# ---------------------------------------------------------------------------


def test_stochastic_round_bf16_properties():
    """Exact on bf16 values, unbiased over 4096 draws, and both neighbours
    drawn (tests/test_bf16_drift.py:159)."""
    gen = torch.Generator().manual_seed(0)
    exact = torch.tensor([0.0, 1.0, -1.0, 0.5, -3.140625])
    assert torch.equal(stochastic_round_bf16(exact, gen).float(), exact)
    x = torch.tensor([1.00390625, -2.0078125, 3.3e-5, -7.77])
    rounds = stochastic_round_bf16(x.expand(4096, 4).contiguous(), gen).float()
    mean = rounds.mean(0).numpy()
    spacing = np.spacing(np.abs(x.numpy())) * 2.0 ** 13  # the bf16 spacing near |x|
    assert np.all(np.abs(mean - x.numpy()) < spacing / 8), (mean, x)
    assert len(torch.unique(rounds[:, 0])) == 2


SMALL = GPTConfig(block_size=32, vocab_size=128, n_layer=2, n_head=2, n_embd=32)


def _rows(seed, accum, b, t):
    return torch.from_numpy(np.random.RandomState(seed).randint(0, SMALL.vocab_size,
                                                                (accum, b, t + 1)))


def _port_loss(cfg):
    return lambda m, r: gpt2.loss(m, r[:, :-1], cfg, targets=r[:, 1:], policy=FP32_POLICY,
                                  ce_chunks=2)


def test_sr_bf16_accumulators_track_fp32():
    """20 steps of accum=4 with stochastically rounded bf16 accumulators track
    the fp32 accumulators' trajectory (tests/test_bf16_drift.py:200)."""
    sched = ScheduleConfig(max_lr=6e-3, min_lr=6e-4, warmup_steps=3, max_steps=20)
    batches = [_rows(100 + i % 4, 4, 4, 16) for i in range(20)]

    def run(accum_dtype):
        model = gpt2.init(SMALL, generator=torch.Generator().manual_seed(3))
        step = make_train_step(_port_loss(SMALL), OptimizerConfig(), sched,
                               decay_mask=gpt2.decay_mask(model), grad_accum_dtype=accum_dtype)
        state = popt.adamw_init(gpt2.named_params(model))
        return np.array([step(model, state, b, i)["loss"] for i, b in enumerate(batches)])

    l32, l16 = run(None), run("bfloat16")
    drop = l32[0] - l32[-1]
    assert drop > 0.3, l32
    assert np.abs(l16 - l32).max() < 0.05 * drop + 0.02, (l32, l16)
    assert not np.array_equal(l16, l32)


def _jax_layerwise(p, micro, gsum, acc):
    rows = micro["rows"]
    return jgpt2.loss_grad_layerwise(p, rows[:, :-1], JCFG, targets=rows[:, 1:], gsum=gsum,
                                     acc=acc, policy=JAX_FP32, ce_chunks=2)


def _port_layerwise(m, r, acc):
    return gpt2.loss_grad_layerwise(m, r[:, :-1], PCFG, targets=r[:, 1:], acc=acc,
                                    policy=FP32_POLICY, ce_chunks=2)


@pytest.mark.parametrize("path", ["layerwise", "bf16_params"])
def test_fp32_accumulator_steps_match_jax(monkeypatch, path):
    """Three steps of accum=2 with explicit fp32 accumulators against the JAX
    step, loss within 1e-5 relative at every step. The layerwise backward
    (fp32 params): grad norm within 1e-5 relative, params within 1e-5. bf16
    params, whose bf16 grads the port folds into fp32 accumulators as JAX
    does: the first step's accumulators within 1e-4 (relative L2) of the sum
    of JAX's per-micro-batch grads, the grad norm within 1e-3 (each bf16 grad
    rounded in its own order). Their params are not compared after Adam,
    which moves a param whose grad is bf16 rounding noise by the LR either
    way; test_adamw_update_compact_state_matches_jax holds that update."""
    from gpt2_vision_language_tpu_torch.train import step as pstep

    jparams = jgpt2.init(jax.random.PRNGKey(0), JCFG)
    lw = path == "layerwise"
    pdtype = torch.float32 if lw else torch.bfloat16
    if not lw:
        jparams = jax.tree.map(lambda p: p.astype(jnp.bfloat16), jparams)

    def jloss(p, micro):
        rows = micro["rows"]
        return jgpt2.loss(p, rows[:, :-1], JCFG, targets=rows[:, 1:], policy=JAX_FP32,
                          ce_chunks=2)

    jstep = jax_make_train_step(jloss, jcfg.OptimizerConfig(), jcfg.ScheduleConfig(**SCHED),
                                decay_mask=jgpt2.decay_mask(jparams), donate=False,
                                layerwise_loss_grad=_jax_layerwise if lw else None)
    jstate = jopt.adamw_init(jparams)
    model = _port_model(jparams, pdtype)
    state = popt.adamw_init(gpt2.named_params(model))
    seen = []
    update = pstep.adamw_update
    monkeypatch.setattr(pstep, "adamw_update", lambda p, g, *a, **k: (
        seen.append({n: t.clone() for n, t in g.items()}), update(p, g, *a, **k)))
    step = make_train_step(_port_loss(PCFG), OptimizerConfig(), ScheduleConfig(**SCHED),
                           decay_mask=gpt2.decay_mask(model), grad_accum_dtype="float32",
                           layerwise_loss_grad=_port_layerwise if lw else None)
    for i in range(3):
        rows = _rows(i, 2, 2, 32)
        if i == 0 and not lw:
            gs = [jax.grad(lambda p, r: jloss(p, {"rows": r}))(jparams, jnp.asarray(r.numpy()))
                  for r in rows]
            want0 = _port_grads(jax.tree.map(
                lambda a, b: a.astype(jnp.float32) + b.astype(jnp.float32), *gs))
        jparams, jstate, jm = jstep(jparams, jstate, {"rows": jnp.asarray(rows.numpy())},
                                    jnp.int32(i))
        m = step(model, state, rows, i)
        assert m["loss"] == pytest.approx(float(jm["loss"]), rel=1e-5), i
        assert m["grad_norm"] == pytest.approx(float(jm["grad_norm"]), rel=1e-5 if lw else 1e-3)
    assert len(seen) == 3 and all(g.dtype == torch.float32 for g in seen[0].values())
    if lw:
        want = gpt2_from_jax_params(_np(jparams), PCFG)
        for n, p in gpt2.named_params(model).items():
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=n)
        return
    for n, w in want0.items():
        assert model.get_parameter(n).dtype == torch.bfloat16
        err = (seen[0][n] - w).norm() / w.norm()
        assert err <= 1e-4, (n, err.item())


class _JaxFp32Acc:
    """The JAX layerwise accumulator adapter with fp32 adds (make_acc of
    train/step.py without stochastic rounding)."""

    @staticmethod
    def block_slice_add(gb, g_lp, i):
        return jax.tree.map(lambda a, g: a.at[i].add(g.astype(jnp.float32)), gb, g_lp)

    @staticmethod
    def tree_add(gsub, dsub):
        return jax.tree.map(lambda a, g: a + g.astype(jnp.float32), gsub, dsub)


def test_loss_grad_layerwise_matches_jax_and_standard():
    """loss_grad_layerwise folded into fp32 accumulators: the loss and every
    gradient within 1e-5 of JAX's gsum from its loss_grad_layerwise, and of
    the port's own standard backward."""
    from gpt2_vision_language_tpu_torch.train.step import GradAccumulators

    jparams = jgpt2.init(jax.random.PRNGKey(1), JCFG)
    rows = _rows(7, 1, 2, 32)[0]
    gsum0 = jax.tree.map(jnp.zeros_like, jparams)
    jloss, gsum = _jax_layerwise(jparams, {"rows": jnp.asarray(rows.numpy())}, gsum0,
                                 _JaxFp32Acc)
    model = _port_model(jparams)
    params = gpt2.named_params(model)
    acc = GradAccumulators(params, {n: True for n in params}, torch.float32, 0)
    loss = _port_layerwise(model, rows, acc)
    assert all(p.grad is None for p in params.values())
    assert loss.item() == pytest.approx(float(jloss), rel=1e-6)
    want = gpt2_from_jax_params(_np(gsum), PCFG)
    _port_loss(PCFG)(model, rows).backward()
    for n, p in params.items():
        np.testing.assert_allclose(acc.sums[n].numpy(), want[n].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=f"JAX {n}")
        np.testing.assert_allclose(acc.sums[n].numpy(), p.grad.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=f"standard {n}")


@pytest.mark.parametrize("mode", ["full", "save_attn", "recompute_gelu", "recompute_mlp"])
def test_remat_mode_equals_none(mode):
    """Each remat mode gives the loss and the gradients of no remat, fp32,
    bit for bit (the same operations, replayed)."""
    model = gpt2.init(SMALL, generator=torch.Generator().manual_seed(5))
    rows = _rows(3, 1, 2, 32)[0]

    def grads(remat):
        for p in model.parameters():
            p.grad = None
        loss = gpt2.loss(model, rows[:, :-1], SMALL, targets=rows[:, 1:], policy=FP32_POLICY,
                         remat=remat)
        loss.backward()
        return loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}

    l0, g0 = grads(False)
    l1, g1 = grads(mode)
    assert torch.equal(l0, l1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    with pytest.raises(ValueError):
        gpt2.run_blocks(model, torch.zeros(1, 4, SMALL.n_embd), SMALL, remat="everything")



# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------


STACK = ["--param-dtype", "bfloat16", "--opt-state-dtype", "int8", "--grad-accum-dtype",
         "bfloat16", "--remat", "full", "--layerwise-grad"]


def test_trainer_with_the_1558m_stack_resumes_exactly(tmp_path, monkeypatch):
    """cli.pretrain --device cpu on a tiny architecture with the whole 1558M
    stack (bf16 params, 8-bit moments, SR-bf16 accumulators, full remat,
    layerwise grads): 3 steps, and 2 steps then a resume to 3, end on the
    same params and moments bit for bit (the rounding's bits are seeded per
    step). A resume under --opt-state-dtype bfloat16 converts the 8-bit
    moments to bf16 tensors and trains on."""
    from gpt2_vision_language_tpu_torch.cli import pretrain as pcli
    from gpt2_vision_language_tpu_torch.data.fineweb import write_synthetic_corpus

    _small_q8(monkeypatch)
    # one small corpus for every run, as the JAX test_int8_recipe_through_workload
    write_synthetic_corpus(str(tmp_path / "data"), vocab_size=256, shard_tokens=1 << 15,
                           n_train=1, n_val=1)
    monkeypatch.setenv("FW_OUT_DIR", str(tmp_path / "data"))
    tiny = GPTConfig(block_size=64, vocab_size=256, n_layer=2, n_head=2, n_embd=64)
    base = ["--micro-batch", "2", "--seq-len", "64", "--total-batch", "256", "--no-hellaswag",
            "--device", "cpu", "--val-every", "0", "--sample-every", "0"]

    def run(log, steps, extra=STACK):
        return pcli.main(base + extra + ["--log-dir", str(tmp_path / log), "--steps", str(steps)],
                         model=tiny)

    a = run("a", 3)
    run("b", 2)
    b = run("b", 3)
    assert a["opt_state"]["step"] == b["opt_state"]["step"] == 3
    for (n, pa), pb in zip(a["model"].named_parameters(), b["model"].parameters()):
        assert pa.dtype == torch.bfloat16 and torch.equal(pa, pb), n
    q8 = [k for k, v in a["opt_state"]["m"].items() if isinstance(v, dict)]
    assert "blocks/mlp/wfc" in q8 and "blocks/ln1/scale" in q8
    for key in ("m", "v"):
        for k, v in a["opt_state"][key].items():
            w = b["opt_state"][key][k]
            same = (torch.equal(v["q"], w["q"]) and torch.equal(v["s"], w["s"])
                    if isinstance(v, dict) else torch.equal(v, w))
            assert same, (key, k)
    c = run("b", 4, ["bfloat16" if x == "int8" else x for x in STACK])
    assert c["opt_state"]["step"] == 4
    assert all(not isinstance(v, dict) and v.dtype == torch.bfloat16
               for v in c["opt_state"]["m"].values())
    assert set(c["opt_state"]["m"]) == set(dict(c["model"].named_parameters()))
