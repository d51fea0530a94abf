"""The PyTorch port's trainer entry point, cli.pretrain, on synthetic shards
at a tiny size: CSV rows and checkpoints, and a resumed run that follows the
uninterrupted one exactly (tests/test_pretrain_workload.py:288)."""

import glob
import os
import tempfile

import pytest
import torch

from gpt2_vision_language_tpu_torch.cli import pretrain
from gpt2_vision_language_tpu_torch.core.config import GPTConfig

TINY = GPTConfig(block_size=64, n_layer=2, n_head=2, n_embd=64)
ARGS = ["--synthetic", "--synthetic-shards", "1", "--micro-batch", "2", "--seq-len", "64",
        "--total-batch", "256", "--no-hellaswag"]


@pytest.fixture(autouse=True)
def _tmp(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # synthetic shards


def _run(log_dir, steps):
    return pretrain.main(ARGS + ["--log-dir", str(log_dir), "--steps", str(steps)], model=TINY)


def _csv_rows(log_dir):
    return [line.split(",") for f in sorted(glob.glob(os.path.join(log_dir, "*.csv")))
            for line in open(f).read().splitlines()[1:]]


def test_pretrain_writes_log_and_checkpoints(tmp_path):
    out = _run(tmp_path / "log", 3)
    assert out["opt_state"]["step"] == 3 and torch.isfinite(torch.tensor(out["val_loss"]))
    phases = [r[1] for r in _csv_rows(tmp_path / "log")]
    assert phases.count("train") == 3 and phases.count("val") == 2  # steps 0 and 2
    assert phases.count("meta") == 2  # tokenizer and argv
    ckpts = set(os.listdir(tmp_path / "log" / "ckpts"))
    assert ckpts == {"model_last.pt", "model_best.pt", "model_final.pt"}


def test_resume_matches_uninterrupted(tmp_path):
    """3 steps, then --steps 6 in the same log dir: the second call resumes
    at step 3 and ends where a 6-step run ends, bit for bit."""
    a = _run(tmp_path / "a", 6)
    _run(tmp_path / "b", 3)
    b = _run(tmp_path / "b", 6)
    assert [int(r[2]) for r in _csv_rows(tmp_path / "b") if r[1] == "train"] == list(range(6))
    assert a["opt_state"]["step"] == b["opt_state"]["step"] == 6
    for (n, pa), pb in zip(a["model"].named_parameters(), b["model"].parameters()):
        assert torch.equal(pa, pb), n
    for key in ("m", "v"):
        for n, t in a["opt_state"][key].items():
            assert torch.equal(t, b["opt_state"][key][n]), (key, n)


def test_hellaswag_is_not_ported(tmp_path, monkeypatch):
    """Named for what it pinned while the evaluator was missing (the run
    raised NotImplementedError). Now: with $HELLASWAG_DIR a directory the
    trainer scores it at step 0 and at the last step and writes the JAX
    trainer's 'hella' rows; --no-hellaswag, or no such directory, writes
    none."""
    import json

    data = tmp_path / "hs"
    data.mkdir()
    with open(data / "hellaswag_val.jsonl", "w") as f:
        for i in range(5):
            f.write(json.dumps({"ctx": f"The number {i} is", "label": i % 4,
                                "endings": ["small", "large!", "a word", "nothing"]}) + "\n")
    monkeypatch.setenv("HELLASWAG_DIR", str(data))
    argv = [a for a in ARGS if a != "--no-hellaswag"]
    pretrain.main(argv + ["--log-dir", str(tmp_path / "log"), "--steps", "2"], model=TINY)
    hella = [r for r in _csv_rows(tmp_path / "log") if r[1] == "hella"]
    assert [int(r[2]) for r in hella] == [0, 1]
    for r in hella:
        acc = float(r[8])
        assert r[3:8] == [""] * 5 and acc in {k / 5 for k in range(6)}
    txt = open(tmp_path / "log" / "log.txt").read()
    assert "0 hella " in txt and "1 hella " in txt
    _run(tmp_path / "off", 1)  # ARGS carry --no-hellaswag
    monkeypatch.setenv("HELLASWAG_DIR", str(tmp_path / "missing"))
    pretrain.main(argv + ["--log-dir", str(tmp_path / "none"), "--steps", "1"], model=TINY)
    for d in ("off", "none"):
        assert not [r for r in _csv_rows(tmp_path / d) if r[1] == "hella"]


def test_flags():
    cfg, args = pretrain.parse_and_build(
        ["--micro-batch", "4", "--seq-len", "512", "--total-batch", "4096",
         "--no-hellaswag", "--save-every", "7", "--log-dir", "x", "--steps", "2"])
    assert (cfg.micro_batch_size, cfg.seq_len, cfg.total_batch_size) == (4, 512, 4096)
    assert (cfg.run_hellaswag, cfg.save_every, cfg.log_dir) == (False, 7, "x")
    assert args.steps == 2 and cfg.grad_accum_steps(1) == 2
    assert cfg.model == GPTConfig(unroll_layers=True) and cfg.attn_impl == "auto"
    assert cfg.hellaswag_every == 250


@pytest.mark.parametrize(
    "argv, block, attn",
    [(["--seq-len", "4096"], 4096, "auto"), (["--seq-len", "16384", "--micro-batch", "1"],
                                             16384, "auto"),
     (["--seq-len", "512"], 1024, "auto"), (["--seq-len", "512", "--block-size", "2048"],
                                            2048, "auto"),
     (["--seq-len", "2048", "--block-size", "4096", "--attn-impl", "flash"], 4096, "flash"),
     (["--attn-impl", "xla"], 1024, "xla")],
)
def test_long_context_flags(argv, block, attn):
    """--seq-len over 1024 grows block_size with it unless --block-size says
    otherwise, as the JAX CLI (cli/pretrain.py:221-226); --attn-impl lands in
    the config."""
    cfg, _ = pretrain.parse_and_build(argv)
    assert (cfg.model.block_size, cfg.attn_impl) == (block, attn)
    assert cfg.model == GPTConfig(unroll_layers=True, block_size=block)


def test_attn_impl_ring_is_refused():
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        pretrain.parse_and_build(["--attn-impl", "ring"])


def test_checkpoint_manager_resumes_furthest(tmp_path):
    """maybe_resume takes whichever of model_last and model_final is further
    along, re-seeds best_val, and a disabled manager neither writes nor
    resumes; no temp file is left behind."""
    from gpt2_vision_language_tpu_torch.ckpt.checkpoint import CheckpointManager

    model = torch.nn.Linear(2, 2)
    state = {"m": {"weight": torch.ones(2, 2)}, "v": {}, "step": 4}
    mgr = CheckpointManager(str(tmp_path), save_every=2)
    mgr.save_step(4, model, state, 1.5, last_step=False)  # rolling + best
    mgr.save_step(5, model, state, 2.0, last_step=False)  # neither
    assert sorted(os.listdir(tmp_path)) == ["model_best.pt", "model_last.pt"]
    fresh = CheckpointManager(str(tmp_path))
    tree, meta = fresh.maybe_resume()
    assert meta["next_step"] == 4 and fresh.best_val == 1.5
    assert torch.equal(tree["opt_state"]["m"]["weight"], torch.ones(2, 2))
    mgr.save_final(6, model, state, 1.7, next_step=7)
    assert fresh.maybe_resume()[1]["next_step"] == 7
    off = CheckpointManager(str(tmp_path / "off"), enabled=False)
    off.save_final(1, model, state, next_step=2)
    assert off.maybe_resume() is None and not os.path.exists(tmp_path / "off")
