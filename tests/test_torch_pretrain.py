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
from torch_threads import share_cores  # noqa: F401  (autouse)

TINY = GPTConfig(block_size=64, n_layer=2, n_head=2, n_embd=64)
ARGS = ["--synthetic", "--synthetic-shards", "1", "--micro-batch", "2", "--seq-len", "64",
        "--total-batch", "256", "--no-hellaswag", "--device", "cpu"]


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
    """Named for what it pinned while ring attention was missing (the flag
    raised NotImplementedError). Now: --attn-impl ring --tp 2 parses to what
    the JAX CLI gives for tp and attn_impl; ring without --tp and a --tp that
    does not divide --seq-len are refused. --tp without ring (Megatron tensor
    parallelism) and --seq-parallel parse to the JAX CLI's fields too, and so
    do the ring with --seq-parallel and with --layerwise-grad, which the JAX
    CLI accepts; a one-process run refuses Megatron tensor parallelism: it
    runs over tp processes."""
    from gpt2_vision_language_tpu.cli import pretrain as jax_pretrain

    argv = ["--attn-impl", "ring", "--tp", "2", "--seq-len", "64"]
    cfg, args = pretrain.parse_and_build(argv)
    want = jax_pretrain.parse_and_build(argv)[0]
    assert (cfg.tp, cfg.attn_impl, cfg.seq_len) == (want.tp, want.attn_impl, want.seq_len)
    assert (cfg.tp, cfg.attn_impl, args.tp) == (2, "ring", 2)
    assert pretrain.parse_and_build([])[0].tp == 1
    with pytest.raises(ValueError, match="requires tp > 1"):
        pretrain.parse_and_build(["--attn-impl", "ring"])
    with pytest.raises(ValueError, match="not divisible"):
        pretrain.parse_and_build(["--attn-impl", "ring", "--tp", "3", "--seq-len", "64"])
    for argv in (["--tp", "2"], ["--tp", "2", "--attn-impl", "flash"],
                 ["--tp", "2", "--seq-parallel"]):
        cfg, _ = pretrain.parse_and_build(argv)
        want = jax_pretrain.parse_and_build(argv)[0]
        assert (cfg.tp, cfg.attn_impl, cfg.seq_parallel) == (
            want.tp, want.attn_impl, want.seq_parallel), argv
    with pytest.raises(ValueError, match="seq_parallel requires tp > 1"):
        pretrain.parse_and_build(["--seq-parallel"])
    for argv in (["--seq-parallel", "--tp", "2", "--attn-impl", "ring"],
                 ["--layerwise-grad", "--tp", "4", "--attn-impl", "ring"]):
        cfg, _ = pretrain.parse_and_build(argv)
        want = jax_pretrain.parse_and_build(argv)[0]
        fields = ("tp", "attn_impl", "seq_parallel", "layerwise_grad", "seq_len")
        assert ([getattr(cfg, f) for f in fields] == [getattr(want, f) for f in fields]), argv
    with pytest.raises(ValueError, match="runs over tp processes"):
        pretrain.main(["--tp", "2", "--device", "cpu", "--steps", "1"])


def test_ring_run_matches_xla_run(tmp_path):
    """Two steps of the tiny model with --attn-impl ring --tp 2 on the CPU end
    at the loss and the weights of the --attn-impl xla run (fp32 sums in
    another order only), and the ring is removed when the run ends."""
    from gpt2_vision_language_tpu_torch.core.precision import FP32_POLICY
    from gpt2_vision_language_tpu_torch.ops import ring_attention as ra
    from gpt2_vision_language_tpu_torch.train.pretrain import run_pretrain

    def run(name, extra):
        cfg, args = pretrain.parse_and_build(
            ARGS + ["--log-dir", str(tmp_path / name), "--steps", "2"] + extra, model=TINY)
        out = run_pretrain(cfg, device="cpu", policy=FP32_POLICY, max_steps_override=args.steps)
        rows = [r for r in _csv_rows(tmp_path / name) if r[1] == "train"]
        return out, [float(r[3]) for r in rows]

    ring, ring_losses = run("ring", ["--attn-impl", "ring", "--tp", "2"])
    assert ra.RING is None
    xla, xla_losses = run("xla", ["--attn-impl", "xla"])
    assert len(ring_losses) == 2
    assert ring_losses == pytest.approx(xla_losses, rel=1e-5)
    assert ring["val_loss"] == pytest.approx(xla["val_loss"], rel=1e-5)
    for (n, a), b in zip(ring["model"].named_parameters(), xla["model"].parameters()):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6, msg=n)


def test_device_flag(tmp_path, monkeypatch):
    """--device defaults to cuda and the CLI raises without a CUDA device
    instead of training on the CPU; --device cpu, the one way to pick the
    device (main takes no device keyword), asks for the CPU."""
    import inspect

    assert pretrain.parse_and_build([])[1].device == "cuda"
    assert "device" not in inspect.signature(pretrain.main).parameters
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in ARGS if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="--device cpu"):
        pretrain.main(argv + ["--log-dir", str(tmp_path / "a"), "--steps", "1"], model=TINY)
    assert not os.path.exists(tmp_path / "a")
    out = pretrain.main(argv + ["--log-dir", str(tmp_path / "b"), "--steps", "1",
                                "--device", "cpu"], model=TINY)
    assert out["opt_state"]["step"] == 1


@pytest.mark.parametrize(
    "argv, field",
    [(["--val-every", "0"], "val_every"), (["--val-every", "7"], "val_every"),
     (["--sample-every", "0"], "sample_every"), (["--sample-every", "9"], "sample_every"),
     (["--no-ckpt"], "save_ckpt"), (["--no-nan-guard"], "nan_guard"),
     (["--model", "124M"], "model"), (["--model", "350M"], "model"),
     (["--model", "774M"], "model"), (["--model", "1558M"], "model"),
     (["--model", "350M", "--seq-len", "2048"], "model")],
)
def test_flags_match_jax_cli(argv, field):
    """Each of these flags gives the config field that the JAX CLI's
    parse_and_build gives (gpt2_vision_language_tpu/cli/pretrain.py:41-113,
    :212-250); --model takes the port's own presets. ``unroll_layers`` is
    left out: the JAX CLI sets it for 350M, and nothing in the port reads it."""
    import dataclasses

    from gpt2_vision_language_tpu.cli import pretrain as jax_pretrain

    got = getattr(pretrain.parse_and_build(argv)[0], field)
    want = getattr(jax_pretrain.parse_and_build(argv)[0], field)
    if field == "model":
        assert type(got).__module__.startswith("gpt2_vision_language_tpu_torch.")
        names = [f.name for f in dataclasses.fields(got) if f.name != "unroll_layers"]
        want = {n: getattr(want, n) for n in names}
        got = {n: getattr(got, n) for n in names}
    assert got == want
    assert getattr(pretrain.parse_and_build([])[0], field) == getattr(
        jax_pretrain.parse_and_build([])[0], field) or field == "model"


def test_model_keyword_wins_over_model_flag():
    """main's and parse_and_build's model= (tiny test architectures) wins
    over --model."""
    cfg, args = pretrain.parse_and_build(["--model", "774M"], model=TINY)
    assert cfg.model == TINY and args.model == "774M"


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


def test_device_side_split_matches_staged_rows():
    """The rows go to the device in their 16 bits and are split and widened
    there: x and y equal what the trainer staged before, the rows widened to
    int32 on the host and sliced (ids up to 65535, past int16's range)."""
    import numpy as np

    from gpt2_vision_language_tpu.data.fineweb import split_rows_on_device as jax_split
    from gpt2_vision_language_tpu_torch.train.pretrain import split_rows_on_device, upload_rows

    rows = np.random.RandomState(0).randint(0, 65536, (3, 2, 9)).astype(np.uint16)
    rows[0, 0, :3] = (0, 32767, 65535)
    staged = torch.from_numpy(rows.astype(np.int32))  # the former stage_rows
    up = upload_rows(rows, torch.device("cpu"))
    assert up.dtype == torch.int16 and up.shape == rows.shape
    got = split_rows_on_device(up)
    assert got["x"].dtype == got["y"].dtype == torch.int32
    assert torch.equal(got["x"], staged[..., :-1]) and torch.equal(got["y"], staged[..., 1:])
    jx, jy = jax_split(rows)
    assert np.array_equal(got["x"].numpy(), np.asarray(jx))
    assert np.array_equal(got["y"].numpy(), np.asarray(jy))


def test_trainer_takes_its_windows_from_the_prefetcher(tmp_path, monkeypatch):
    """The pretrain loop reads its training windows through
    data/pipeline.HostPrefetcher (one window a step, staged by the thread)
    and closes it when the run ends."""
    from gpt2_vision_language_tpu_torch.data import pipeline
    from gpt2_vision_language_tpu_torch.train import pretrain as tp

    seen = {"next": 0, "closed": 0}

    class Counting(pipeline.HostPrefetcher):
        def next(self):
            seen["next"] += 1
            return super().next()

        def close(self):
            seen["closed"] += 1
            super().close()

    monkeypatch.setattr(tp, "HostPrefetcher", Counting)
    _run(tmp_path / "log", 2)
    assert seen == {"next": 2, "closed": 1}
