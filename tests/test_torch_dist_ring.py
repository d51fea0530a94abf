"""The pretrain ring spread over gloo processes, one sequence chunk a rank
(ops.ring_attention.GroupRing over the mesh's model group): a train step on 2
and 4 processes against the one-process LocalRing step and the JAX ring step
on a (1, n) mesh from the same weights, and run_pretrain(attn_impl="ring",
tp=n) over n processes against the one-process ring run. Tolerances: those
of tests/test_torch_ring_attention.py (loss rtol 1e-5, gradients 2e-5) and,
against JAX, of tests/test_sharding.py."""

import os

import numpy as np
import pytest
import torch

from gpt2_vision_language_tpu_torch.data.fineweb import write_synthetic_corpus
from torch_dist import OPT, SCHED, assert_matches_jax, jax_steps, port_init, run_ranks, whole
from torch_threads import share_cores  # noqa: F401  (autouse)

ARCH = dict(block_size=32, vocab_size=256, n_layer=2, n_head=2, n_embd=64)


@pytest.mark.parametrize("n", [2, 4])
def test_process_ring_step_matches_local_ring_and_jax(tmp_path, n):
    import jax

    from gpt2_vision_language_tpu.parallel.mesh import make_mesh

    rows = np.random.RandomState(3).randint(0, 256, (1, 2, 2, 17)).astype(np.int32)
    np.save(tmp_path / "rows.npy", rows)
    p0, metrics, after = jax_steps(ARCH, rows, ring_mesh=make_mesh(n, ("data", "model"),
                                                                  shape=(1, n)))
    job = {"kind": "step", "model": ARCH, "policy": "fp32", "rows": str(tmp_path / "rows.npy"),
           "init": port_init(p0, ARCH, tmp_path / "init.pt"), "opt": OPT, "sched": SCHED,
           "ring": True}
    local = run_ranks(dict(job, tag="local", mesh=[1, 1], ring_size=n), 1, tmp_path)[0]
    recs = run_ranks(dict(job, tag="group", mesh=[1, n]), n, tmp_path)
    assert all(r["metrics"] == recs[0]["metrics"] for r in recs)
    assert recs[0]["grad_allreduces"] == 1  # every grad partial: one all-reduce a step
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(recs[0]["metrics"][0][key], local["metrics"][0][key],
                                   rtol=1e-5)
    got, want = whole(tmp_path, "group"), whole(tmp_path, "local")
    for name, g in want["grads"].items():
        torch.testing.assert_close(got["grads"][name], g, rtol=2e-5, atol=2e-5, msg=name)
    assert_matches_jax(recs[0], got["after"], metrics, after, ARCH, f"ring {n}")


@pytest.mark.parametrize("n", [2, 4])
def test_run_pretrain_ring_over_processes_matches_one_process(tmp_path, monkeypatch, n):
    """run_pretrain(attn_impl="ring", tp=n) on n processes (each holding T/n
    of every sequence) against the same run on one process (the ranks run
    in turn): per-step losses and the final val loss within 1e-5."""
    monkeypatch.delenv("HELLASWAG_DIR", raising=False)
    data = tmp_path / "data"
    write_synthetic_corpus(str(data), shard_tokens=1 << 15, n_train=1, n_val=1)

    def job(tag):
        return {"kind": "pretrain", "tag": tag, "policy": "fp32",
                "model": dict(block_size=64, n_layer=2, n_head=2, n_embd=64), "max_steps": 2,
                "pretrain": {"total_batch_size": 2 * 32 * 2, "micro_batch_size": 2,
                             "seq_len": 32, "schedule": SCHED, "optimizer": OPT,
                             "val_every": 2, "val_steps": 1, "sample_every": 2,
                             "run_hellaswag": False, "save_every": 100, "attn_impl": "ring",
                             "tp": n, "data_dir": str(data), "log_dir": str(tmp_path / tag)}}

    recs = run_ranks(dict(job("group"), devices=n), n, tmp_path)
    one = run_ranks(job("one"), 1, tmp_path)[0]
    assert all(r["param_sums"] == recs[0]["param_sums"] for r in recs)
    assert recs[0]["launch_counts"] == one["launch_counts"]  # CPU: plain versions, none
    np.testing.assert_allclose(recs[0]["val_loss"], one["val_loss"], rtol=1e-5)

    def losses(tag):
        out = []
        for f in sorted(os.listdir(tmp_path / tag)):
            if f.endswith(".csv"):
                out += [float(line.split(",")[3]) for line in
                        open(tmp_path / tag / f).read().splitlines()[1:]
                        if line.split(",")[1] == "train"]
        return out

    assert len(losses("one")) == 2
    np.testing.assert_allclose(losses("group"), losses("one"), rtol=1e-5)
