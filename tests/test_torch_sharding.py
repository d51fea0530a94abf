"""Megatron tensor parallelism of the port over gloo processes against the
JAX single-device step (tests/test_sharding.py's cases): the specs of every
leaf, a TP step on 2 and 4 processes with 6 heads (4 ranks hold 2, 2, 1, 1),
data x model = 2 x 2, sequence parallelism and the layerwise backward under
TP (int8 moments under TP: tests/test_torch_pipeline.py). JAX's tolerances
under the fp32 policy: loss and grad norm rtol 1e-5, params after one step
rtol 1e-4, atol 1e-5."""

import jax
import numpy as np
import pytest
import torch

from gpt2_vision_language_tpu.core import config as jcfg
from gpt2_vision_language_tpu.models import gpt2 as jgpt2
from gpt2_vision_language_tpu.parallel.sharding import gpt2_param_specs as jax_specs
from gpt2_vision_language_tpu_torch.ckpt.convert import jax_leaf_path
from gpt2_vision_language_tpu_torch.core.config import GPTConfig
from gpt2_vision_language_tpu_torch.models import gpt2
from gpt2_vision_language_tpu_torch.parallel import sharding
from torch_dist import SCHED, OPT, assert_matches_jax, jax_steps, port_init, run_ranks, whole
from torch_threads import share_cores  # noqa: F401  (autouse)

# 6 heads: the 4-way split is uneven (2, 2, 1, 1), as 1558M's 25 over 4
ARCH = dict(block_size=32, vocab_size=256, n_layer=2, n_head=6, n_embd=192)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX single-device step (plain and layerwise) on one batch of
    accum 2 x B 4 x T 16, and the JAX init as a port state dict file."""
    tmp = tmp_path_factory.mktemp("tp")
    rows = np.random.RandomState(0).randint(0, 256, (1, 2, 4, 17)).astype(np.int32)
    np.save(tmp / "rows.npy", rows)
    p0, metrics, after = jax_steps(ARCH, rows)
    _, lw_metrics, lw_after = jax_steps(ARCH, rows, layerwise=True)
    job = {"kind": "step", "model": ARCH, "policy": "fp32", "rows": str(tmp / "rows.npy"),
           "init": port_init(p0, ARCH, tmp / "init.pt"), "opt": OPT, "sched": SCHED}
    return {"job": job, "plain": (metrics, after), "layerwise": (lw_metrics, lw_after)}


def _leaf_paths(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_paths(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("cross", [False, True])
def test_param_specs_match_jax(cross):
    """Every port parameter's spec is the JAX gpt2_param_specs entry of the
    JAX leaf it belongs to, by leaf path; the split ones are exactly the
    column, row and vocab leaves."""
    arch = dict(ARCH, img_embd=24, cross_attention=True) if cross else ARCH
    params = jgpt2.init(jax.random.PRNGKey(0), jcfg.GPTConfig(**arch))
    want = {path: tuple(spec) for path, spec in _leaf_paths(jax_specs(params))}
    model = gpt2.GPT2(GPTConfig(**arch))
    got = sharding.gpt2_param_specs(gpt2.named_params(model))
    assert set(got) == set(gpt2.named_params(model))
    for n, spec in got.items():
        path = jax_leaf_path(n)[0]
        assert spec == want[path], n
    split = {n for n, s in got.items() if "model" in s}
    assert sharding.sharded_names(got) == split


@pytest.mark.parametrize("n_head, ways, counts", [(6, 4, [2, 2, 1, 1]), (25, 4, [7, 6, 6, 6]),
                                                  (12, 2, [6, 6])])
def test_heads_split_whole_and_every_index_once(n_head, ways, counts):
    """Whole heads a rank, unevenly where they must; over the ranks each
    split parameter's indices cover its split axis exactly once, a QKV rank
    holding its heads' rows in each of q, k and v."""
    cfg = GPTConfig(block_size=16, vocab_size=200, n_layer=1, n_head=n_head,
                    n_embd=n_head * 8)
    assert sharding.split_counts(n_head, ways) == counts
    tps = [sharding.TensorParallel(None, r, ways, cfg) for r in range(ways)]
    model = gpt2.GPT2(cfg)
    for n, p in model.state_dict().items():
        where = [tp.index(n, p.shape) for tp in tps]
        if where[0] is None:
            assert n not in sharding.sharded_names([n])
            continue
        dim = where[0][0]
        idx = torch.cat([w[1] for w in where])
        assert sorted(idx.tolist()) == list(range(p.shape[dim])), n
        if n.endswith("c_attn.weight"):
            hs = cfg.head_dim
            assert len(where[-1][1]) == 3 * counts[-1] * hs
            assert where[1][1][0] == counts[0] * hs  # rank 1's first q row
            assert where[1][1][counts[1] * hs] == cfg.n_embd + counts[0] * hs  # its first k row


@pytest.mark.parametrize("mesh, extra", [
    ([1, 2], {}), ([1, 4], {}), ([2, 2], {}),
    ([1, 4], {"seq_parallel": True}), ([2, 2], {"seq_parallel": True}),
    ([1, 2], {"remat": "recompute_mlp"}),
], ids=["tp2", "tp4", "dp2xtp2", "sp4", "dp2xsp2", "tp2-recompute_mlp"])
def test_tp_step_matches_single_device_jax(reference, tmp_path, mesh, extra):
    """One train step (accum 2) on data x model gloo processes from the JAX
    init against the JAX single-device step: loss, grad norm, every updated
    parameter (gathered whole). The ranks of 4-way TP compute 2, 2, 1, 1
    heads; under sequence parallelism each holds T/4 of the residual
    stream; the MLP's remat Function takes the row-parallel bias once."""
    n = mesh[0] * mesh[1]
    tag = "tp" + "x".join(map(str, mesh)) + "".join(map(str, extra.values()))
    recs = run_ranks(dict(reference["job"], tag=tag, mesh=mesh, **extra), n, tmp_path)
    want_heads = sharding.split_counts(ARCH["n_head"], mesh[1])
    assert [r["local_heads"] for r in recs] == [want_heads[r % mesh[1]] for r in range(n)]
    for r in recs[1:]:  # the loss and the norm are the same on every rank
        assert r["metrics"] == recs[0]["metrics"]
    metrics, after = reference["plain"]
    assert_matches_jax(recs[0], whole(tmp_path, tag)["after"], metrics, after, ARCH, tag)
    # one flat all-reduce per group a step: the partial leaves over the world
    # (sequence parallelism), the rest over data
    assert recs[0]["grad_allreduces"] == bool(extra.get("seq_parallel")) + (mesh[0] > 1)


def test_layerwise_grad_tp_matches_single_device_jax(reference, tmp_path):
    """The layerwise backward (models.gpt2.loss_grad_layerwise) on 4 TP
    processes against the JAX single-device layerwise step."""
    recs = run_ranks(dict(reference["job"], tag="lw", mesh=[1, 4], layerwise=True), 4,
                     tmp_path)
    metrics, after = reference["layerwise"]
    assert_matches_jax(recs[0], whole(tmp_path, "lw")["after"], metrics, after, ARCH, "lw")


@pytest.mark.parametrize("mesh, fault", [([2, 1], "skip_allreduce"),
                                         ([1, 4], "count_replicated")])
def test_controls_fail(reference, tmp_path, mesh, fault):
    """A data-parallel step that skips the grad all-reduce, and a TP step
    whose clip norm counts every replicated leaf tp times, fall outside the
    tolerance of the checks above."""
    recs = run_ranks(dict(reference["job"], tag=fault, mesh=mesh, fault=fault),
                     mesh[0] * mesh[1], tmp_path)
    metrics, after = reference["plain"]
    with pytest.raises(AssertionError):
        assert_matches_jax(recs[0], whole(tmp_path, fault)["after"], metrics, after, ARCH,
                           fault)
    rel = abs(recs[0]["metrics"][0]["grad_norm"] / metrics[0]["grad_norm"] - 1)
    assert rel > 1e-2, rel
