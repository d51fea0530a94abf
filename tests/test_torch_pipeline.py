"""The GPipe pipeline and 8-bit moments under TP and PP, over gloo processes,
against the JAX single-device step (tests/test_pipeline.py's cases, from the
JAX init carried over by ckpt/convert.gpt2_from_jax_params): pp = 2 for three
steps, pp_micro 4 against 2, pp x dp, pp x tp, int8 moments under pp x dp
and under TP = 2 for two steps each, the controls outside the tolerances,
the placement's specs against JAX pipeline_param_pspecs, and every refusal
of train/pretrain.check_parallel. JAX's own tolerances under the fp32
policy: loss rtol 2e-5, grad norm rtol 1e-3, params rtol 2e-4 / atol 2e-5
(3e-5 for int8 moments). Every launch is shared by the checks of its
process count."""

import dataclasses

import jax
import numpy as np
import pytest

from gpt2_vision_language_tpu.core import config as jcfg
from gpt2_vision_language_tpu.models import gpt2 as jgpt2
from gpt2_vision_language_tpu.parallel.pipeline import pipeline_param_pspecs as jax_pp_specs
from gpt2_vision_language_tpu_torch.ckpt.convert import (gpt2_from_jax_params, jax_leaf_path,
                                                          opt_state_from_jax)
from gpt2_vision_language_tpu_torch.core.config import GPTConfig, OptimizerConfig, PretrainConfig
from gpt2_vision_language_tpu_torch.models import gpt2
from gpt2_vision_language_tpu_torch.parallel import pipeline
from gpt2_vision_language_tpu_torch.tools import dist_worker
from gpt2_vision_language_tpu_torch.train.optimizer import jax_leaves
from gpt2_vision_language_tpu_torch.train.pretrain import check_parallel
from torch_dist import OPT, SCHED, jax_steps, port_init, run_jobs, whole
from torch_threads import share_cores  # noqa: F401  (autouse)

# tests/test_pipeline.py's shapes: 4 layers (2 a stage), 2 heads (1 a TP rank)
ARCH = dict(block_size=16, vocab_size=128, n_layer=4, n_head=2, n_embd=32)
# its int8 shapes: wte 512 x 128, wqkv (2, 128, 384), wfc (2, 128, 512) take 8-bit moments
ARCH_Q8 = dict(block_size=32, vocab_size=512, n_layer=2, n_head=4, n_embd=128)
TOL = {"loss": 2e-5, "grad_norm": 1e-3, "rtol": 2e-4, "atol": 2e-5, "atol_q8": 3e-5}


def _job(tmp, name, arch, rows, **kw):
    np.save(tmp / f"{name}.npy", rows)
    return {"kind": "step", "model": arch, "policy": "fp32", "rows": str(tmp / f"{name}.npy"),
            "opt": OPT, "sched": SCHED, **kw}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX references and one 2-process and one 4-process launch of the
    port's worker, every case's job in it."""
    tmp = tmp_path_factory.mktemp("pp")
    rows = np.random.RandomState(11).randint(0, 128, (3, 2, 4, 17)).astype(np.int32)
    rows_q8 = np.random.RandomState(13).randint(0, 512, (2, 2, 4, 33)).astype(np.int32)
    p0, metrics, after = jax_steps(ARCH, rows)
    q_state = {}
    q0, q_metrics, q_after = jax_steps(ARCH_Q8, rows_q8, state_dtype="int8", state_out=q_state)
    base = _job(tmp, "rows", ARCH, rows, init=port_init(p0, ARCH, tmp / "init.pt"))
    q8 = _job(tmp, "rows_q8", ARCH_Q8, rows_q8, init=port_init(q0, ARCH_Q8, tmp / "q8.pt"),
              opt_state_dtype="int8", reference=True)
    two = run_jobs([
        dict(base, tag="pp2", mesh=[1, 1], pp=2),
        dict(base, tag="pp2_micro4", mesh=[1, 1], pp=2, pp_micro=4),
        dict(base, tag="pp2_drop_backward_hop", mesh=[1, 1], pp=2, fault="drop_backward_hop"),
        dict(base, tag="pp2_count_replicated", mesh=[1, 1], pp=2, fault="count_replicated"),
        dict(q8, tag="int8_tp2", mesh=[1, 2]),
        dict(q8, tag="int8_tp2_per_shard", mesh=[1, 2], fault="per_shard_q8"),
    ], 2, tmp, "two")
    four = run_jobs([
        dict(base, tag="pp2xdp2", mesh=[2, 1], pp=2),
        dict(base, tag="pp2xtp2", mesh=[1, 2], pp=2),
        dict(q8, tag="int8_pp2xdp2", mesh=[2, 1], pp=2),
    ], 4, tmp, "four")
    state = opt_state_from_jax(q_state["state"], GPTConfig(**ARCH_Q8))
    codes = {mv: {k: v for k, v in state[mv].items() if isinstance(v, dict)} for mv in ("m", "v")}
    return {"tmp": tmp, "recs": {**two, **four}, "plain": (metrics, after),
            "int8": (q_metrics, q_after), "codes": codes}


def _assert_jax(runs, tag, *, int8=False):
    """A run's metrics and whole params after its steps against the JAX
    single-device steps', at JAX's pipeline tolerances. With 8-bit moments
    the parameters of the 8-bit leaves are held to rtol 2e-4 plus one
    quantization step instead of atol 3e-5: the port's own one-process int8
    run is off JAX's by more than 3e-5 in single elements, each where fp32
    rounding moved one code of m across a rounding boundary (4.5e-5 in wte,
    5.9e-5 in a c_proj weight at these shapes)."""
    recs = runs["recs"][tag]
    arch = ARCH_Q8 if int8 else ARCH
    jax_metrics, jax_after = runs["int8" if int8 else "plain"]
    for r in recs[1:]:  # the loss and the norm are the same on every rank
        assert r["metrics"] == recs[0]["metrics"], tag
    for i, (m, jm) in enumerate(zip(recs[0]["metrics"], jax_metrics)):
        np.testing.assert_allclose(m["loss"], jm["loss"], rtol=TOL["loss"], err_msg=f"{tag} {i}")
        np.testing.assert_allclose(m["grad_norm"], jm["grad_norm"], rtol=TOL["grad_norm"],
                                   err_msg=f"{tag} {i}")
    assert len(recs[0]["metrics"]) == len(jax_metrics)
    want = gpt2_from_jax_params(jax_after, GPTConfig(**arch))
    want.pop("lm_head.weight")
    after = whole(runs["tmp"], tag)["after"]
    assert set(after) == set(gpt2.named_params(gpt2.GPT2(GPTConfig(**arch))))
    q8_names = set()
    if int8:
        steps = len(jax_metrics)
        outside = dist_worker.q8_outside(after, want, runs["codes"], jax_metrics[-1]["lr"], steps,
                                         OptimizerConfig(**OPT))
        assert outside and not any(outside.values()), (tag, outside)
        q8_names = {n for path in outside for n in jax_leaves(want)[path].names}
    for n, t in after.items():
        if n not in q8_names:
            np.testing.assert_allclose(t.numpy(), want[n].numpy(), rtol=TOL["rtol"],
                                       atol=TOL["atol_q8" if int8 else "atol"],
                                       err_msg=f"{tag} {n}")


@pytest.mark.parametrize("tag", ["pp2", "pp2_micro4", "pp2xdp2", "pp2xtp2"])
def test_pipeline_step_matches_single_device_jax(runs, tag):
    """The pipelined step (3 steps at pp = 2; one at pp x dp; 3 at pp x tp)
    against the JAX single-device step: loss and grad norm of every step,
    every parameter gathered whole. Each stage holds its two layers."""
    _assert_jax(runs, tag)
    recs = runs["recs"][tag]
    assert [r["stage_layers"] for r in recs] == [[0, 1], [2, 3]] * (len(recs) // 2) or \
        [r["stage_layers"] for r in recs] == [[0, 1], [0, 1], [2, 3], [2, 3]]
    # each stage sends its output forward and its input's cotangent back once
    # a sub-batch: 2 micro-batches x n_micro
    n_micro = 4 if tag.endswith("micro4") else 2
    assert recs[0]["collectives"]["send"] == recs[0]["collectives"]["recv"] == 2 * n_micro


def test_pp_micro_does_not_change_the_result(runs):
    """4 sub-batches a micro-batch give the trajectory of 2 (JAX
    test_pipeline_microbatch_counts' tolerance)."""
    a, b = (whole(runs["tmp"], t)["after"] for t in ("pp2", "pp2_micro4"))
    for n in a:
        np.testing.assert_allclose(a[n].numpy(), b[n].numpy(), rtol=2e-5, atol=2e-5, err_msg=n)


@pytest.mark.parametrize("tag", ["int8_tp2", "int8_pp2xdp2"])
def test_int8_moments_match_single_device_jax(runs, tag):
    """8-bit moments under TP = 2 and under pp x dp, two steps from
    adamw_init(state_dtype="int8"): the block grid taken over the whole JAX
    leaf, so the quantized trajectory is the single-device one; each rank
    keeps its slice of the codes (half of each leaf's)."""
    _assert_jax(runs, tag, int8=True)
    recs = runs["recs"][tag]
    assert len({r["moment_bytes"] for r in recs}) == 1
    # against the port's one-process int8 run from the same state (rank 0's):
    # the codes equal but in a thousandth of them, every parameter within
    # 2e-4 and one quantization step (chip_smoke.Q8_LIMITS)
    errs = recs[0]["errors"]
    assert errs["loss_rel"] <= TOL["loss"] and errs["grad_norm_rel"] <= TOL["grad_norm"], errs
    assert errs["params_outside"] == 0 and errs["codes_differ"] <= 1e-3, errs


@pytest.mark.parametrize("tag", ["pp2_drop_backward_hop", "pp2_count_replicated",
                                 "int8_tp2_per_shard"])
def test_controls_fail(runs, tag):
    """A pipeline that drops the backward hop (stage 0's grads zero), a clip
    norm that counts the replicated leaves once per stage, and 8-bit moments
    requantized on each rank's own grid fall outside the tolerances."""
    with pytest.raises(AssertionError):
        _assert_jax(runs, tag, int8=tag.startswith("int8"))
    if tag.startswith("int8"):  # the codes are not the one-process run's
        assert runs["recs"][tag][0]["errors"]["codes_differ"] > 1e-2


@pytest.mark.parametrize("tp", [False, True])
def test_pipeline_param_specs_match_jax(tp):
    """Every port parameter's placement is JAX pipeline_param_pspecs' entry of
    the JAX leaf it belongs to: the block leaves on "pipe", the rest
    replicated, the Megatron "model" entries kept under pp x tp."""
    params = jgpt2.init(jax.random.PRNGKey(0), jcfg.GPTConfig(**ARCH))
    flat = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"{prefix}{k}"] = v

    walk(jax_pp_specs(params, tp=tp))
    model = gpt2.GPT2(GPTConfig(**ARCH))
    got = pipeline.pipeline_param_pspecs(gpt2.named_params(model), tp=tp)
    assert set(got) == set(gpt2.named_params(model))
    for n, spec in got.items():
        assert tuple(spec) == tuple(flat[jax_leaf_path(n)[0]]), n


def test_stage_holds_its_layers():
    """cut_stage keeps a stage's layers, their names and the replicated
    leaves; the other places hold nothing; local_stage picks the same names
    out of a whole tree."""
    model = gpt2.GPT2(GPTConfig(**ARCH))
    whole_sd = model.state_dict()
    stage = pipeline.Stage(1, 2, ARCH["n_layer"])
    pipeline.cut_stage(model, stage)
    names = set(gpt2.named_params(model))
    assert {pipeline.layer_of(n) for n in names} == {None, 2, 3}
    assert set(pipeline.local_stage(whole_sd, stage)) == set(model.state_dict())
    assert isinstance(model.transformer.h[0], pipeline.Elsewhere)
    with pytest.raises(RuntimeError, match="another pipeline stage"):
        gpt2.run_blocks(model, np.zeros(1), model.cfg)


@pytest.mark.parametrize("change, match", [
    ({"pp": 2, "seq_parallel": True, "tp": 2}, "pp excludes seq_parallel"),
    ({"pp": 2, "attn_impl": "ring", "tp": 2}, "pp excludes ring attention"),
    ({"pp": 2, "layerwise_grad": True}, "pp excludes layerwise_grad"),
    ({"pp": 5}, "n_layer 12 is not divisible by pp=5"),
    ({"pp": 2, "micro_batch_size": 8, "pp_micro": 3}, "not divisible by pp_micro=3"),
])
def test_check_parallel_refuses_what_jax_asserts(change, match):
    with pytest.raises(ValueError, match=match):
        check_parallel(dataclasses.replace(PretrainConfig(), **change))


def test_check_parallel_refuses_a_world_the_mesh_cannot_fill():
    cfg = dataclasses.replace(PretrainConfig(), pp=2, tp=2)
    check_parallel(cfg)  # the configuration alone is fine
    check_parallel(cfg, world=8)
    with pytest.raises(ValueError, match="devices 6 not divisible by pp\\*tp=4"):
        check_parallel(cfg, world=6)
