"""The port's trainer over two gloo processes (tests/test_distributed_2proc.py
on the port): data-parallel run_pretrain with validation, a HellaSwag file of
5 examples (3 and 2 a rank: the short rank's lockstep flush runs), sampling,
master-only checkpoints and a second invocation that resumes, against the
one-process port run and the JAX single-process run at the same global
batch; then a TP checkpoint resumed by one process, and the other way
round."""

import json
import os

import numpy as np
import pytest
import torch

from gpt2_vision_language_tpu_torch.ckpt.checkpoint import CheckpointManager, save_checkpoint
from gpt2_vision_language_tpu_torch.data.fineweb import write_synthetic_corpus
from gpt2_vision_language_tpu_torch.train.optimizer import adamw_init
from torch_dist import OPT, port_init, run_ranks
from torch_threads import share_cores  # noqa: F401  (autouse)

ARCH = dict(block_size=64, n_layer=2, n_head=2, n_embd=64)
T, B_RANK = 32, 2
SCHED = dict(max_lr=1e-3, min_lr=1e-4, warmup_steps=2, max_steps=6)


def _write_hellaswag(path, n=5):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "hellaswag_val.jsonl"), "w") as f:
        for i in range(n):
            f.write(json.dumps({"ctx": f"The number {i} is", "label": i % 4,
                                "endings": ["small", "large!", "a word", "nothing"]}) + "\n")


def _rows(log_dir, phase, col):
    """step -> column ``col`` of the ``phase`` rows, first occurrence (a
    resumed run runs its saved step's validation again)."""
    out = {}
    for name in sorted(os.listdir(log_dir), key=lambda f: os.path.getmtime(os.path.join(log_dir, f))):
        if name.endswith(".csv"):
            for line in open(os.path.join(log_dir, name)).read().splitlines()[1:]:
                parts = line.split(",")
                if parts[1] == phase:
                    out.setdefault(int(parts[2]), float(parts[col]))
    return out


def _plant(log_dir, state_dict_path):
    """The JAX init as a checkpoint the run resumes at step 0: the port runs
    start from the weights the JAX run starts from."""
    sd = torch.load(state_dict_path, weights_only=True)
    params = {n: p for n, p in sd.items() if n != "lm_head.weight"}
    save_checkpoint(os.path.join(log_dir, "ckpts", "model_final.pt"),
                    {"model": sd, "opt_state": adamw_init(params)}, {"step": -1, "next_step": 0})


def _job(tag, data_dir, log_dir, micro, max_steps, **extra):
    return {"kind": "pretrain", "tag": tag, "model": ARCH, "policy": "fp32", "max_steps": max_steps,
            "pretrain": {"total_batch_size": 2 * B_RANK * T * 2, "micro_batch_size": micro,
                         "seq_len": T, "schedule": SCHED, "optimizer": OPT, "val_every": 2,
                         "val_steps": 2, "hellaswag_every": 2, "sample_every": 2,
                         "save_every": 2, "data_dir": str(data_dir), "log_dir": str(log_dir),
                         **extra}}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("corpus")
    write_synthetic_corpus(str(tmp / "data"), shard_tokens=1 << 15, n_train=1, n_val=1)
    _write_hellaswag(str(tmp / "hs"))
    return tmp


def test_two_process_pretrain_matches_one_process_and_jax(corpus, tmp_path, monkeypatch):
    import jax

    from gpt2_vision_language_tpu.core import config as jcfg
    from gpt2_vision_language_tpu.models import gpt2 as jgpt2
    from gpt2_vision_language_tpu.train.pretrain import run_pretrain as jax_run_pretrain

    data, hs = corpus / "data", str(corpus / "hs")
    seed = 1337
    jarch = jcfg.GPTConfig(**ARCH)
    p0 = jax.tree.map(np.asarray, jgpt2.init(jax.random.PRNGKey(seed), jarch))
    init = port_init(p0, ARCH, tmp_path / "init.pt")
    log2, log1 = tmp_path / "log2p", tmp_path / "log1p"
    for d in (log2, log1):
        _plant(str(d), init)

    # two processes, B=2 each: 4 steps, then a second invocation to step 6
    job = dict(_job("fresh", data, log2, B_RANK, 4), hellaswag_dir=hs, devices=2)
    fresh = run_ranks(job, 2, tmp_path)
    assert [r["step"] for r in fresh] == [4, 4]
    assert fresh[0]["param_sums"] == fresh[1]["param_sums"]  # replicated, bit for bit
    run_ranks(dict(job, tag="resume", max_steps=6), 2, tmp_path)
    logs = [open(tmp_path / f"resume_log{r}.txt").read() for r in range(2)]
    assert "[ckpt] resumed at step 4" in logs[0] and "[ckpt]" not in logs[1]
    assert "sample 0:" in logs[0] and "sample 0:" not in logs[1]
    resumed = [json.load(open(tmp_path / f"resume_r{r}.json")) for r in range(2)]
    assert resumed[0]["param_sums"] == resumed[1]["param_sums"]
    # the master wrote one CSV an invocation and every checkpoint
    assert len([f for f in os.listdir(log2) if f.endswith(".csv")]) == 2
    assert set(os.listdir(log2 / "ckpts")) == {"model_last.pt", "model_best.pt",
                                               "model_final.pt"}

    # one process at the same global batch (B=4), in this process
    monkeypatch.setenv("HELLASWAG_DIR", hs)
    one = run_ranks(_job("one", data, log1, 2 * B_RANK, 6), 1, tmp_path)[0]

    # the JAX single-process run from the same init, its train rows only
    jlog = tmp_path / "logjax"
    jcfg_run = jcfg.PretrainConfig(
        model=jarch, total_batch_size=2 * B_RANK * T * 2, micro_batch_size=2 * B_RANK,
        seq_len=T, schedule=jcfg.ScheduleConfig(**SCHED), optimizer=jcfg.OptimizerConfig(**OPT),
        val_every=0, sample_every=0, run_hellaswag=False, save_ckpt=False, seed=seed,
        data_dir=str(data), log_dir=str(jlog))
    from gpt2_vision_language_tpu.core.precision import FP32_POLICY as JAX_FP32
    jax_run_pretrain(jcfg_run, policy=JAX_FP32, num_devices=1)

    two, single, ref = (_rows(d, "train", 3) for d in (log2, log1, jlog))
    assert set(two) == set(single) == set(ref) == set(range(6))
    for step in range(6):
        np.testing.assert_allclose(two[step], single[step], rtol=1e-5, err_msg=f"step {step}")
        np.testing.assert_allclose(single[step], ref[step], rtol=1e-5, err_msg=f"step {step}")
    np.testing.assert_allclose(resumed[0]["val_loss"], one["val_loss"], rtol=1e-5)
    for n, (s, a) in one["param_sums"].items():
        np.testing.assert_allclose(resumed[0]["param_sums"][n], [s, a], rtol=1e-5, atol=1e-6,
                                   err_msg=n)
    # HellaSwag: counts summed over the ranks = the one-process counts (the
    # first invocation also scored its last step, 3)
    h2, h1 = _rows(log2, "hella", 8), _rows(log1, "hella", 8)
    assert set(h1) == {0, 2, 4, 5} and set(h2) == set(h1) | {3}
    assert all(h2[s] == acc for s, acc in h1.items())
    v2, v1 = _rows(log2, "val", 3), _rows(log1, "val", 3)
    assert set(v2) == set(v1) | {3}
    for step, v in v1.items():
        np.testing.assert_allclose(v2[step], v, rtol=1e-5, err_msg=f"val {step}")


@pytest.mark.parametrize("first, then", [("tp", "one"), ("one", "tp")])
def test_checkpoints_cross_tensor_parallel_and_one_process(corpus, tmp_path, monkeypatch,
                                                           first, then):
    """Two steps under 2-way Megatron TP (or one process), then the same log
    dir extended to 4 steps by one process (or TP): the resumed steps' losses
    equal a straight one-process 4-step run's within 1e-5."""
    monkeypatch.delenv("HELLASWAG_DIR", raising=False)
    data = corpus / "data"
    quiet = dict(sample_every=0, run_hellaswag=False)

    def run(tag, log, steps, how):
        job = _job(tag, data, log, 2 * B_RANK, steps, **quiet)
        if how == "tp":
            job["pretrain"]["tp"] = 2
            return run_ranks(dict(job, devices=2), 2, tmp_path)[0]
        return run_ranks(job, 1, tmp_path)[0]

    run("a", tmp_path / "x", 2, first)
    run("b", tmp_path / "x", 4, then)
    run("c", tmp_path / "y", 4, "one")
    got, want = _rows(tmp_path / "x", "train", 3), _rows(tmp_path / "y", "train", 3)
    assert set(got) == set(want) == set(range(4))
    for step in range(4):
        np.testing.assert_allclose(got[step], want[step], rtol=1e-5, err_msg=f"step {step}")


def test_checkpoint_manager_non_master_writes_nothing_and_reads(tmp_path):
    """CheckpointManager(is_master=False): every save makes the tree (its
    tree_fn runs: a collective under TP) but writes nothing, not even the
    directory; the resume reads what the master wrote."""
    made = []

    def tree_fn(model, opt_state):
        made.append(1)
        return {"model": {"w": torch.ones(2)}, "opt_state": opt_state}

    d = str(tmp_path / "ckpts")
    other = CheckpointManager(d, save_every=1, is_master=False, tree_fn=tree_fn)
    other.save_step(1, None, {"step": 1}, 0.5, last_step=False)
    other.save_final(1, None, {"step": 1}, 0.5, next_step=2)
    assert len(made) == 2 and not os.path.exists(d)
    assert other.maybe_resume() is None
    master = CheckpointManager(d, save_every=1, tree_fn=tree_fn)
    master.save_step(1, None, {"step": 1}, 0.5, last_step=False)
    master.save_final(1, None, {"step": 1}, 0.5, next_step=2)
    tree, meta = other.maybe_resume()
    assert meta["next_step"] == 2 and torch.equal(tree["model"]["w"], torch.ones(2))
    assert other.best_val == 0.5
