"""The port's pretrain command line under Megatron TP with sequence
parallelism over two gloo processes, as ``python -m torch.distributed.run
... cli.pretrain --devices 2 --tp 2 --seq-parallel`` runs it (the worker's
``"cli"`` job): validation, a HellaSwag file of 5 examples, sampling,
checkpoints of gathered trees written by the master alone, and a second
invocation that resumes; held against the one-process command line on the
same arguments. The same of ``cli.pretrain --devices 2 --pp 2`` (the GPipe
pipeline): its resume against the uninterrupted run, its losses against one
process's, its checkpoint resumed by one process. Also: a worker job that
names no device asks for the card."""

import os
import shutil
import tempfile

import numpy as np
import pytest
import torch

from gpt2_vision_language_tpu_torch.cli import pretrain as cli
from gpt2_vision_language_tpu_torch.core.config import GPTConfig
from gpt2_vision_language_tpu_torch.models import gpt2
from gpt2_vision_language_tpu_torch.tools import dist_worker
from test_torch_dist_pretrain import _rows, _write_hellaswag
from torch_dist import run_ranks
from torch_threads import share_cores  # noqa: F401  (autouse)

# 4 heads: 2 a rank
ARCH = dict(block_size=64, n_layer=2, n_head=4, n_embd=64)
ARGS = ["--synthetic", "--synthetic-shards", "1", "--micro-batch", "2", "--seq-len", "32",
        "--total-batch", "128", "--val-every", "1", "--save-every", "1", "--sample-every", "1",
        "--device", "cpu"]
TP_ARGS = ["--devices", "2", "--tp", "2", "--seq-parallel"]


def test_cli_tp_sp_two_processes_matches_one_process(tmp_path, monkeypatch):
    hs = str(tmp_path / "hs")
    _write_hellaswag(hs)
    monkeypatch.setenv("TMPDIR", str(tmp_path))  # the ranks' synthetic shards
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # this process's
    log2, log1 = tmp_path / "log2p", tmp_path / "log1p"
    job = {"kind": "cli", "tag": "tp_sp", "model": ARCH, "hellaswag_dir": hs,
           "argv": ARGS + TP_ARGS + ["--log-dir", str(log2), "--steps", "2"]}
    fresh = run_ranks(job, 2, tmp_path)
    assert [r["step"] for r in fresh] == [2, 2]
    logs = [open(tmp_path / f"tp_sp_log{r}.txt").read() for r in range(2)]
    assert "backend gloo" in logs[0] and "mesh: Mesh(data=1, model=2" in logs[0]
    hella = [_hella_totals(log) for log in logs]
    resumed = run_ranks(dict(job, tag="tp_sp_resume",
                             argv=job["argv"][:-1] + ["3"]), 2, tmp_path)
    assert [r["step"] for r in resumed] == [3, 3]
    logs = [open(tmp_path / f"tp_sp_resume_log{r}.txt").read() for r in range(2)]
    assert "[ckpt] resumed at step 2" in logs[0] and "[ckpt]" not in logs[1]
    hella += [_hella_totals(log) for log in logs]
    # HellaSwag at the first and the last step of the first invocation and
    # at the resumed step: the one data rank's 5 examples (both model ranks
    # run its forwards), printed by the master alone
    assert hella == [[5, 5], [], [5], []]
    assert "sample 0:" in logs[0] and "sample 0:" not in logs[1]
    assert set(os.listdir(log2 / "ckpts")) == {"model_last.pt", "model_best.pt",
                                               "model_final.pt"}
    # the checkpoints hold whole tensors: the one-process model's shapes
    sd = torch.load(log2 / "ckpts" / "model_final.pt", weights_only=False)["model"]
    whole = gpt2.GPT2(GPTConfig(**ARCH)).state_dict()
    assert {n: tuple(t.shape) for n, t in sd.items()} == {
        n: tuple(t.shape) for n, t in whole.items()}

    monkeypatch.setenv("HELLASWAG_DIR", hs)
    one = cli.main(ARGS + ["--log-dir", str(log1), "--steps", "3"], model=GPTConfig(**ARCH))
    assert one["opt_state"]["step"] == 3
    two, single = _rows(log2, "train", 3), _rows(log1, "train", 3)
    assert set(two) == set(single) == {0, 1, 2}
    # bf16 compute (the command line's policy): the row-parallel partial
    # products are rounded before their sum, the one-process run's after
    for step in range(3):
        np.testing.assert_allclose(two[step], single[step], rtol=2e-3, err_msg=f"step {step}")
    v2, v1 = _rows(log2, "val", 3), _rows(log1, "val", 3)
    assert set(v2) == set(v1) == {0, 1, 2}
    for step, v in v1.items():
        np.testing.assert_allclose(v2[step], v, rtol=2e-3, err_msg=f"val {step}")
    # (the first invocation also scored its last step, 1)
    h2, h1 = _rows(log2, "hella", 8), _rows(log1, "hella", 8)
    assert set(h1) == {0, 2} and set(h2) == {0, 1, 2}
    assert all(h2[s] == acc for s, acc in h1.items())


def _hella_totals(log: str) -> list:
    """The example counts of a log's ``HellaSwag accuracy: c/t=...`` lines."""
    return [int(ln.split("/")[1].split("=")[0]) for ln in log.splitlines()
            if ln.startswith("HellaSwag accuracy:")]


def test_worker_job_without_device_asks_for_the_card(tmp_path, monkeypatch):
    """A job that names no device runs on the card (local rank i on cuda:i),
    never silently on the CPU: with no card it raises."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    np.save(tmp_path / "rows.npy", np.zeros((1, 1, 2, 9), np.int32))
    job = {"kind": "step", "model": dict(ARCH, n_layer=1), "rows": str(tmp_path / "rows.npy")}
    with pytest.raises(RuntimeError, match="--device cuda"):
        dist_worker.run_job(job)


PP_ARGS = ["--devices", "2", "--pp", "2"]


def test_cli_pipeline_two_processes_resume_and_one_process_load(tmp_path, monkeypatch):
    """``cli.pretrain --devices 2 --pp 2`` (a stage of one layer a process,
    validation through the pipeline, HellaSwag and sampling on the gathered
    stages, checkpoints of whole trees by the master): two steps and a
    resume to three give the uninterrupted three-step run's state bit for
    bit; its losses follow the one-process command line's; its final
    checkpoint loads in a one-process run, which resumes from it."""
    hs = str(tmp_path / "hs")
    _write_hellaswag(hs)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    logs = {k: tmp_path / k for k in ("split", "whole", "one")}
    job = {"kind": "cli", "model": ARCH, "hellaswag_dir": hs}

    def run(tag, log, steps):
        return run_ranks(dict(job, tag=tag, argv=ARGS + PP_ARGS + ["--log-dir", str(log),
                                                                    "--steps", str(steps)]),
                         2, tmp_path)

    first = run("pp", logs["split"], 2)
    assert [r["step"] for r in first] == [2, 2]
    text = open(tmp_path / "pp_log0.txt").read()
    assert "mesh: Mesh(data=1, pipe=2" in text and "stage 0 of 2" in text
    assert "[pp] stages gathered for the event" in text and "sample 0:" in text
    resumed = run("pp_resume", logs["split"], 3)
    assert "[ckpt] resumed at step 2" in open(tmp_path / "pp_resume_log0.txt").read()
    straight = run("pp_whole", logs["whole"], 3)
    # each rank's own parameters (its stage's layer and the replicated leaves)
    assert [r["param_sums"] for r in resumed] == [r["param_sums"] for r in straight]
    assert set(resumed[0]["param_sums"]) != set(resumed[1]["param_sums"])
    a, b = (torch.load(logs[k] / "ckpts" / "model_final.pt", weights_only=False)
            for k in ("split", "whole"))
    whole = gpt2.GPT2(GPTConfig(**ARCH)).state_dict()
    assert {n: tuple(t.shape) for n, t in a["model"].items()} == {
        n: tuple(t.shape) for n, t in whole.items()}
    for n in whole:
        assert torch.equal(a["model"][n], b["model"][n]), n
    for mv in ("m", "v"):
        for n, t in b["opt_state"][mv].items():
            assert torch.equal(a["opt_state"][mv][n], t), (mv, n)
    # the losses of the uninterrupted run against one process's (bf16: the
    # sub-batches' GEMMs round otherwise than the whole micro-batch's)
    monkeypatch.setenv("HELLASWAG_DIR", hs)
    cli.main(ARGS + ["--log-dir", str(logs["one"]), "--steps", "3"], model=GPTConfig(**ARCH))
    two, single = _rows(logs["whole"], "train", 3), _rows(logs["one"], "train", 3)
    assert set(two) == set(single) == {0, 1, 2}
    for step in range(3):
        np.testing.assert_allclose(two[step], single[step], rtol=2e-3, err_msg=f"step {step}")
    v2, v1 = _rows(logs["whole"], "val", 3), _rows(logs["one"], "val", 3)
    for step, v in v1.items():
        np.testing.assert_allclose(v2[step], v, rtol=2e-3, err_msg=f"val {step}")
    # the pipeline's checkpoint resumed by one process
    load = tmp_path / "load"
    os.makedirs(load / "ckpts")
    shutil.copy(logs["whole"] / "ckpts" / "model_final.pt", load / "ckpts" / "model_final.pt")
    out = cli.main(ARGS + ["--log-dir", str(load), "--steps", "4"], model=GPTConfig(**ARCH))
    assert out["opt_state"]["step"] == 4
    assert set(_rows(load, "train", 3)) == {3}
