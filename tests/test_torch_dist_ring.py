"""The pretrain ring over gloo processes as the JAX trainer composes it: the
Megatron placement of params and moments over the mesh's model group, each
attention's heads swapped for a sequence chunk of every head by an
all-to-all (parallel/collectives.HeadsToChunks / ChunksToHeads) around the
ring (ops.ring_attention.GroupRing over that group), with sequence
parallelism and with the layerwise backward. Held against the one-process
LocalRing step and the JAX single-device ring step from the same weights;
run_pretrain(attn_impl="ring", tp=n) over n processes against the one-process
ring run; ring checkpoints resumed by one process and back; the controls
(an all-to-all whose backward is the identity on the rank's own block, a
ring whose merge drops its weights) fail. Tolerances: those of
tests/test_torch_ring_attention.py (loss rtol 1e-5, gradients 2e-5) and,
against JAX, of tests/test_sharding.py."""

import jax
import numpy as np
import pytest
import torch

from gpt2_vision_language_tpu.core import config as jcfg
from gpt2_vision_language_tpu.models import gpt2 as jgpt2
from gpt2_vision_language_tpu.parallel.mesh import make_mesh
from gpt2_vision_language_tpu.parallel.sharding import gpt2_param_specs as jax_specs
from gpt2_vision_language_tpu_torch.ckpt.convert import jax_leaf_path
from gpt2_vision_language_tpu_torch.core.config import GPTConfig
from gpt2_vision_language_tpu_torch.data.fineweb import write_synthetic_corpus
from gpt2_vision_language_tpu_torch.models import gpt2
from gpt2_vision_language_tpu_torch.parallel import sharding
from test_torch_dist_pretrain import _rows
from test_torch_sharding import _leaf_paths
from torch_dist import (OPT, SCHED, assert_matches_jax, jax_steps, port_init, run_a2a, run_jobs,
                        run_ranks, whole)
from torch_threads import share_cores  # noqa: F401  (autouse)

# 4 heads: one a rank at tp = 4, two at tp = 2
ARCH = dict(block_size=32, vocab_size=256, n_layer=2, n_head=4, n_embd=64)
# tests/test_torch_pipeline.py's int8 shapes: wte, wqkv and wfc take 8-bit
# moments, each a multiple of 4 blocks of 256 (a slice a rank at tp = 4)
ARCH_Q8 = dict(block_size=32, vocab_size=512, n_layer=2, n_head=4, n_embd=128)


def _ring_mesh(n):
    return make_mesh(n, ("data", "model"), shape=(1, n))


@pytest.mark.parametrize("n", [2, 4])
def test_all_to_all_pair_round_trips_uneven_heads(tmp_path, n):
    """5 heads over 2 (3, 2) and 4 (2, 1, 1, 1) ranks: HeadsToChunks gives
    every head over the rank's chunk of T, ChunksToHeads gives the rank's
    heads back bit for bit (fp32 and bf16), and each one's backward is the
    other's forward."""
    recs = run_a2a(n, 5, tmp_path)
    want = sharding.split_counts(5, n)
    assert [r["heads"] for r in recs] == [want] * n
    assert all(r["chunk_shape"] == [2, 8 // n, 3, 5, 4] for r in recs)
    assert all(r["all_to_all"] == 6 for r in recs)  # 2 forwards, 2 backwards, 2 bf16


def _shares(cfg: GPTConfig, n: int, r: int) -> dict:
    """port name -> the element count rank r of n holds under the Megatron
    split of the JAX leaf's spec (whole heads, MLP columns, vocab rows)."""
    params = jgpt2.init(jax.random.PRNGKey(0), jcfg.GPTConfig(**ARCH))
    specs = {path: tuple(spec) for path, spec in _leaf_paths(jax_specs(params))}
    heads, hidden, vocab = (sharding.split_counts(k, n) for k in
                            (cfg.n_head, 4 * cfg.n_embd, cfg.padded_vocab_size))
    out = {}
    for name, p in gpt2.named_params(gpt2.GPT2(cfg)).items():
        path = jax_leaf_path(name)[0]
        whole_n = p.numel()
        if "model" not in specs[path]:
            out[name] = whole_n
        elif path.endswith("wte"):
            out[name] = whole_n // cfg.padded_vocab_size * vocab[r]
        elif path.rsplit("/", 1)[-1] in ("wfc", "bfc", "wproj"):
            out[name] = whole_n // (4 * cfg.n_embd) * hidden[r]
        else:
            out[name] = whole_n // cfg.n_head * heads[r]
    return out


@pytest.mark.parametrize("n", [2, 4])
def test_process_ring_step_matches_local_ring_and_jax(tmp_path, n):
    """A train step of the ring over n processes: each rank holds its
    Megatron shards (n_head / n heads) and their moments, the grads need no
    all-reduce (no leaf is partial without sequence parallelism), and the
    step matches the one-process LocalRing step and the JAX ring step."""
    rows = np.random.RandomState(3).randint(0, 256, (1, 2, 2, 17)).astype(np.int32)
    np.save(tmp_path / "rows.npy", rows)
    p0, metrics, after = jax_steps(ARCH, rows, ring_mesh=_ring_mesh(n))
    job = {"kind": "step", "model": ARCH, "policy": "fp32", "rows": str(tmp_path / "rows.npy"),
           "init": port_init(p0, ARCH, tmp_path / "init.pt"), "opt": OPT, "sched": SCHED,
           "ring": True}
    local = run_ranks(dict(job, tag="local", mesh=[1, 1], ring_size=n), 1, tmp_path)[0]
    recs = run_ranks(dict(job, tag="group", mesh=[1, n]), n, tmp_path)
    assert all(r["metrics"] == recs[0]["metrics"] for r in recs)
    assert [r["local_heads"] for r in recs] == [ARCH["n_head"] // n] * n
    assert recs[0]["grad_allreduces"] == 0
    # a micro-batch: 2 layers x 2 swaps forward and 2 backward; the ring's
    # n - 1 hops forward and backward a layer
    assert recs[0]["collectives"]["all_to_all"] == 2 * 2 * 4
    assert recs[0]["collectives"]["exchange"] == 2 * 2 * 2 * (n - 1)
    for r, rec in enumerate(recs):
        share = sum(_shares(GPTConfig(**ARCH), n, r).values())
        assert rec["param_bytes"] == 4 * share < rec["whole_param_bytes"]
        assert rec["moment_bytes"] == 2 * rec["param_bytes"]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(recs[0]["metrics"][0][key], local["metrics"][0][key],
                                   rtol=1e-5)
    got, want = whole(tmp_path, "group"), whole(tmp_path, "local")
    for name, g in want["grads"].items():
        torch.testing.assert_close(got["grads"][name], g, rtol=2e-5, atol=2e-5, msg=name)
    assert_matches_jax(recs[0], got["after"], metrics, after, ARCH, f"ring {n}")


@pytest.fixture(scope="module")
def compositions(tmp_path_factory):
    """One launch of 4 processes: the ring with sequence parallelism on a
    (2, 2) mesh (tp = 2), the ring with the layerwise backward at tp = 4,
    the two controls at tp = 4 and the ring with 8-bit moments at tp = 4;
    with the JAX single-device ring and layerwise steps on the same rows
    from the same init."""
    tmp = tmp_path_factory.mktemp("ring")
    rows = np.random.RandomState(5).randint(0, 256, (1, 2, 4, 17)).astype(np.int32)
    np.save(tmp / "rows.npy", rows)
    p0, metrics, after = jax_steps(ARCH, rows, ring_mesh=_ring_mesh(4))
    _, lw_metrics, lw_after = jax_steps(ARCH, rows, layerwise=True, ring_mesh=_ring_mesh(4))
    base = {"model": ARCH, "policy": "fp32", "rows": str(tmp / "rows.npy"),
            "init": port_init(p0, ARCH, tmp / "init.pt"), "opt": OPT, "sched": SCHED,
            "ring": True, "mesh": [1, 4]}
    rows_q8 = np.random.RandomState(6).randint(0, 512, (2, 2, 4, 33)).astype(np.int32)
    np.save(tmp / "rows_q8.npy", rows_q8)
    jobs = [dict(base, tag="ring_sp", mesh=[2, 2], seq_parallel=True),
            dict(base, tag="ring_lw", layerwise=True),
            dict(base, tag="a2a_identity_backward", fault="a2a_identity_backward"),
            dict(base, tag="drop_merge_weights", fault="drop_merge_weights"),
            {"tag": "ring_int8", "model": ARCH_Q8, "policy": "fp32", "ring": True,
             "mesh": [1, 4], "rows": str(tmp / "rows_q8.npy"), "opt": OPT, "sched": SCHED,
             "opt_state_dtype": "int8", "reference": True, "save_whole": False}]
    recs = run_jobs(jobs, 4, tmp, "ring_jobs")
    return {"tmp": tmp, "recs": recs, "plain": (metrics, after),
            "layerwise": (lw_metrics, lw_after)}


def test_ring_with_seq_parallel_matches_jax(compositions):
    """tp = 2 ring with the residual stream T-sharded between blocks, on 2
    data ranks: the JAX ring step; the replicated leaves' grads summed over
    the world in one all-reduce."""
    recs = compositions["recs"]["ring_sp"]
    assert [r["local_heads"] for r in recs] == [2, 2, 2, 2]
    assert all(r["metrics"] == recs[0]["metrics"] for r in recs)
    assert recs[0]["grad_allreduces"] == 2  # partial leaves over the world, the rest over data
    assert recs[0]["collectives"]["all_to_all"] == 2 * 2 * 4
    metrics, after = compositions["plain"]
    assert_matches_jax(recs[0], whole(compositions["tmp"], "ring_sp")["after"], metrics, after,
                       ARCH, "ring + sp")


def test_ring_with_layerwise_grad_matches_jax(compositions):
    """tp = 4 ring under the layerwise backward (each block recomputed from
    its saved input): the JAX single-device layerwise step; the recompute
    swaps and rotates once more a layer."""
    recs = compositions["recs"]["ring_lw"]
    assert recs[0]["collectives"]["all_to_all"] == 2 * 2 * 6
    assert recs[0]["collectives"]["exchange"] == 2 * 2 * 3 * 3
    metrics, after = compositions["layerwise"]
    assert_matches_jax(recs[0], whole(compositions["tmp"], "ring_lw")["after"], metrics, after,
                       ARCH, "ring + layerwise")


def test_ring_shards_are_the_jax_spec_split(compositions):
    """Every rank of the tp = 4 ring holds, of each leaf, the elements the
    JAX gpt2_param_specs entry splits to it over "model" (whole heads, MLP
    columns, vocab rows; the replicated leaves whole), and fp32 moments of
    the same size; the ranks' shares of each split leaf add up to it."""
    cfg = GPTConfig(**ARCH)
    recs = compositions["recs"]["ring_lw"]
    whole_n = {n: p.numel() for n, p in gpt2.named_params(gpt2.GPT2(cfg)).items()}
    shares = [_shares(cfg, 4, r) for r in range(4)]
    for r, rec in enumerate(recs):
        got = {n: int(np.prod(s)) for n, s in rec["param_shapes"].items()}
        assert got == shares[r], r
        assert rec["moment_bytes"] == 2 * 4 * sum(got.values())
    for n in sharding.sharded_names(whole_n):
        assert sum(s[n] for s in shares) == whole_n[n], n


def test_ring_int8_moments_take_the_tp_grid(compositions):
    """8-bit moments under the ring at tp = 4, two steps: each rank holds a
    slice of each 8-bit leaf's codes on the whole leaf's block grid (JAX
    ``shard_moments`` / ``moment_specs``), and against the one-process int8
    ring run from the same state the codes are equal but in a thousandth of
    them, every parameter within 2e-4 and one quantization step
    (chip_smoke.Q8_LIMITS)."""
    recs = compositions["recs"]["ring_int8"]
    errs = recs[0]["errors"]
    assert errs["loss_rel"] <= 2e-5 and errs["grad_norm_rel"] <= 1e-3, errs
    assert errs["params_outside"] == 0 and errs["codes_differ"] <= 1e-3, errs
    assert len({r["moment_bytes"] for r in recs}) == 1
    assert recs[0]["moment_bytes"] <= recs[0]["reference"]["moment_bytes"] / 2


@pytest.mark.parametrize("fault", ["a2a_identity_backward", "drop_merge_weights"])
def test_ring_controls_fail(compositions, fault):
    """The all-to-all's backward taken as the identity on the rank's own block
    (no exchange), and the ring's merge without its softmax weights, fall
    outside the tolerance of the checks above."""
    recs = compositions["recs"][fault]
    metrics, after = compositions["plain"]
    with pytest.raises(AssertionError):
        assert_matches_jax(recs[0], whole(compositions["tmp"], fault)["after"], metrics, after,
                           ARCH, fault)


def _pretrain_job(tag, data, log, steps, **extra):
    return {"kind": "pretrain", "tag": tag, "policy": "fp32", "max_steps": steps,
            "model": dict(block_size=64, n_layer=2, n_head=4, n_embd=64),
            "pretrain": {"total_batch_size": 2 * 32 * 2, "micro_batch_size": 2, "seq_len": 32,
                         "schedule": SCHED, "optimizer": OPT, "val_every": 2, "val_steps": 1,
                         "sample_every": 2, "run_hellaswag": False, "save_every": 100,
                         "data_dir": str(data), "log_dir": str(log), **extra}}


@pytest.mark.parametrize("n", [2, 4])
def test_run_pretrain_ring_over_processes_matches_one_process(tmp_path, monkeypatch, n):
    """run_pretrain(attn_impl="ring", tp=n) on n processes (each holding its
    Megatron shards, its attention the ring over them) against the same run
    on one process (the ranks run in turn): per-step losses and the final
    val loss within 1e-5."""
    monkeypatch.delenv("HELLASWAG_DIR", raising=False)
    data = tmp_path / "data"
    write_synthetic_corpus(str(data), shard_tokens=1 << 15, n_train=1, n_val=1)

    def job(tag):
        return _pretrain_job(tag, data, tmp_path / tag, 2, attn_impl="ring", tp=n)

    recs = run_ranks(dict(job("group"), devices=n), n, tmp_path)
    one = run_ranks(job("one"), 1, tmp_path)[0]
    assert all(r["val_loss"] == recs[0]["val_loss"] for r in recs)
    assert recs[0]["launch_counts"] == one["launch_counts"]  # CPU: plain versions, none
    np.testing.assert_allclose(recs[0]["val_loss"], one["val_loss"], rtol=1e-5)
    got, want = _rows(tmp_path / "group", "train", 3), _rows(tmp_path / "one", "train", 3)
    assert set(got) == set(want) == {0, 1}
    np.testing.assert_allclose([got[s] for s in (0, 1)], [want[s] for s in (0, 1)], rtol=1e-5)


@pytest.mark.parametrize("first, then", [("ring", "one"), ("one", "ring")])
def test_ring_checkpoints_cross_one_process(tmp_path, monkeypatch, first, then):
    """Two steps of the ring over 2 processes (with sequence parallelism
    before one process, with the layerwise backward after it), or of one
    process, then the same log dir extended to 4 steps by the other: the
    resumed steps' losses equal a straight one-process 4-step run's within
    1e-5. The ring's checkpoints hold whole trees, as TP's do."""
    monkeypatch.delenv("HELLASWAG_DIR", raising=False)
    data = tmp_path / "data"
    write_synthetic_corpus(str(data), shard_tokens=1 << 15, n_train=1, n_val=1)

    def run(tag, log, steps, how, comp):
        job = _pretrain_job(tag, data, log, steps, sample_every=0)
        if how == "ring":
            job["pretrain"].update(attn_impl="ring", tp=2, **{comp: True})
            return run_ranks(dict(job, devices=2), 2, tmp_path)[0]
        return run_ranks(job, 1, tmp_path)[0]

    run("a", tmp_path / "x", 2, first, "seq_parallel")
    run("b", tmp_path / "x", 4, then, "layerwise_grad")
    run("c", tmp_path / "y", 4, "one", None)
    sd = torch.load(tmp_path / "x" / "ckpts" / "model_final.pt", weights_only=False)["model"]
    want_shapes = {n: tuple(t.shape) for n, t in gpt2.GPT2(GPTConfig(
        **_pretrain_job("s", data, tmp_path, 1)["model"])).state_dict().items()}
    assert {n: tuple(t.shape) for n, t in sd.items()} == want_shapes
    got, want = _rows(tmp_path / "x", "train", 3), _rows(tmp_path / "y", "train", 3)
    assert set(got) == set(want) == set(range(4))
    for step in range(4):
        np.testing.assert_allclose(got[step], want[step], rtol=1e-5, err_msg=f"step {step}")
