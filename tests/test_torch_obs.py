"""The port's ProfilerHook (obs/csvlog.py), the JAX trainer's profiler window
on torch.profiler: off without PROFILE_DIR, a Chrome trace written when the
window closes and not before, and the trainer calling it once a step."""

import glob
import json
import os
import tempfile

import pytest
import torch

from gpt2_vision_language_tpu_torch.cli import pretrain
from gpt2_vision_language_tpu_torch.core.config import GPTConfig
from gpt2_vision_language_tpu_torch.obs import csvlog
from gpt2_vision_language_tpu_torch.train import pretrain as trainer
from torch_threads import share_cores  # noqa: F401  (autouse)


def _work():
    x = torch.randn(64, 64)
    return (x @ x).sum().item()


def test_no_trace_without_profile_dir(tmp_path, monkeypatch):
    monkeypatch.delenv("PROFILE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    hook = csvlog.ProfilerHook(start_step=1, num_steps=1)
    assert (hook.start, hook.stop) == (1, 2)
    for step in range(4):
        _work()
        hook.step(step)
        assert hook._prof is None
    assert not os.listdir(tmp_path)


def test_trace_is_written_when_the_window_closes(tmp_path, monkeypatch):
    out = tmp_path / "prof"
    monkeypatch.setenv("PROFILE_DIR", str(out))
    hook = csvlog.ProfilerHook(start_step=1, num_steps=2)
    try:
        for step in range(3):
            _work()
            hook.step(step)
            assert not glob.glob(str(out / "*.json"))  # open from step 1 on
            assert (hook._prof is not None) == (step >= 1)
        _work()
        hook.step(3)  # start_step + num_steps: the window closes
        assert hook._prof is None
        (trace,) = glob.glob(str(out / "*.pt.trace.json"))
        names = {e.get("name") for e in json.load(open(trace))["traceEvents"]}
        assert "aten::mm" in names
        hook.step(4)
        assert hook._prof is None and len(glob.glob(str(out / "*.json"))) == 1
    finally:
        if hook._prof is not None:
            hook._prof.stop()


def test_run_pretrain_calls_the_hook_once_a_step(tmp_path, monkeypatch):
    """A 2-step synthetic run on the CPU: the hook is made once and called
    after each step's log line, with the step."""
    calls = []

    class Spy(csvlog.ProfilerHook):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            calls.append(("init", self.start, self.stop))

        def step(self, step):
            rows = open(glob.glob(str(tmp_path / "log" / "*.csv"))[0]).read().splitlines()
            assert rows[-1].split(",")[1:3] == ["train", str(step)]  # after its log line
            calls.append(step)
            super().step(step)

    monkeypatch.setattr(trainer, "ProfilerHook", Spy)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # synthetic shards
    monkeypatch.delenv("PROFILE_DIR", raising=False)
    pretrain.main(["--synthetic", "--synthetic-shards", "1", "--micro-batch", "2", "--seq-len",
                   "64", "--total-batch", "256", "--no-hellaswag", "--device", "cpu",
                   "--no-ckpt", "--log-dir", str(tmp_path / "log"), "--steps", "2"],
                  model=GPTConfig(block_size=64, n_layer=2, n_head=2, n_embd=64))
    assert calls == [("init", 10, 15), 0, 1]


@pytest.mark.parametrize("start, num", [(10, 5), (0, 3)])
def test_window_names_match_jax(start, num):
    from gpt2_vision_language_tpu.obs import csvlog as jlog

    ours, theirs = csvlog.ProfilerHook(start, num), jlog.ProfilerHook(start, num)
    assert (ours.dir, ours.start, ours.stop) == (theirs.dir, theirs.start, theirs.stop)
