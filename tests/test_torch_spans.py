"""The port's spans (obs/spans.py): off they cost one flag test and record
nothing; on they nest per thread, carry the step and their thread's id, and
lie on the clock of torch.profiler's Chrome trace. One train step at a tiny
size shows every span of the step where it is placed, and the prefetcher
counts its waits."""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from gpt2_vision_language_tpu_torch.core.config import GPTConfig, OptimizerConfig, ScheduleConfig
from gpt2_vision_language_tpu_torch.core.precision import FP32_POLICY
from gpt2_vision_language_tpu_torch.data.pipeline import HostPrefetcher
from gpt2_vision_language_tpu_torch.models import gpt2
from gpt2_vision_language_tpu_torch.obs import spans
from gpt2_vision_language_tpu_torch.train.optimizer import adamw_init, adamw_update, global_norm
from gpt2_vision_language_tpu_torch.train.pretrain import split_rows_on_device
from gpt2_vision_language_tpu_torch.train.step import make_train_step
from torch_threads import share_cores  # noqa: F401  (autouse)


@pytest.fixture
def recording():
    """Spans on for the test, off and drained after it."""
    spans.drain()
    spans.enable()
    yield
    spans.disable()
    spans.drain()


def test_off_hands_out_the_shared_object_and_reads_no_clock(monkeypatch):
    def clock():
        raise AssertionError("a clock was read with the spans off")

    spans.disable()
    spans.drain()
    monkeypatch.setattr(spans, "_now", clock)
    monkeypatch.setattr(time, "time_ns", clock)
    assert not spans.enabled()
    assert spans.span("linear.fwd") is spans.NOOP
    assert spans.span("step.micro", i=3) is spans.NOOP
    assert spans.step_span(5) is spans.NOOP
    with spans.span("step.norm") as s:
        spans.annotate("step.norm", kernel=3)
    assert s is spans.NOOP
    assert spans.drain() == []


def test_enable_drops_what_closed_after_the_last_window(recording):
    """A span open at disable() still records when it closes; the next
    enable() starts from an empty list, so it lands in no later window."""
    with spans.span("data.produce"):
        spans.disable()
    assert [r.name for r in spans.drain()] == ["data.produce"]
    spans.enable()
    with spans.span("data.stage"):
        spans.disable()
    spans.enable()
    with spans.span("step.micro", i=0):
        pass
    assert [r.name for r in spans.drain()] == ["step.micro"]


def test_on_nests_per_thread_with_the_step_and_thread(recording):
    opened, release = threading.Event(), threading.Event()
    seen = {}

    def worker():
        with spans.span("data.produce"):
            opened.set()
            release.wait(5)
        seen["tid"] = threading.get_native_id()
        seen["pthread"] = threading.get_ident()

    with spans.step_span(7):
        with spans.span("step.micro", i=0):
            with spans.span("linear.fwd"):
                spans.annotate("linear.fwd", note="x")
                spans.annotate("step.micro", outer=1)  # not the innermost: found by name
                spans.annotate("ce.fwd", lost=1)  # none open: nothing
            t = threading.Thread(target=worker)
            t.start()
            assert opened.wait(5)
            release.set()
            t.join(10)
            assert not t.is_alive()
    with spans.step_span(8):
        pass
    recs = {r.name if r.name != "step" else f"step{r.attrs['step']}": r for r in spans.drain()}
    assert set(recs) == {"step7", "step8", "step.micro", "linear.fwd", "data.produce"}
    main = threading.get_native_id()
    assert recs["step.micro"].parent == recs["step7"].id
    assert recs["linear.fwd"].parent == recs["step.micro"].id
    assert recs["step7"].parent == recs["step8"].parent == -1
    assert recs["data.produce"].parent == -1  # nesting is per thread
    assert recs["data.produce"].tid == seen["tid"] != main
    assert recs["data.produce"].pthread == seen["pthread"] != threading.get_ident()
    assert {recs[n].tid for n in ("step7", "step.micro", "linear.fwd")} == {main}
    assert {recs[n].pthread for n in ("step7", "step.micro", "linear.fwd")} == {
        threading.get_ident()}
    assert {recs[n].step for n in ("step7", "step.micro", "linear.fwd", "data.produce")} == {7}
    assert recs["step8"].step == 8
    assert recs["step.micro"].attrs == {"i": 0, "outer": 1}
    assert recs["linear.fwd"].attrs == {"note": "x"}
    r = recs["step7"]
    assert r.start_ns <= recs["step.micro"].start_ns <= recs["step.micro"].end_ns <= r.end_ns
    assert abs(r.start_ns - time.time_ns()) < 60e9  # Unix time
    assert spans.drain() == []


def test_threads_lose_no_record(recording):
    """More threads than cores open nested spans at once, switching often:
    every record is kept, ids are unique, and each inner span's parent is
    its own thread's outer one."""
    n_threads, n_spans = 2 * (os.cpu_count() or 1) + 2, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_spans):
                with spans.span("outer"):
                    with spans.span("inner"):
                        pass

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    recs = spans.drain()
    assert len(recs) == 2 * n_threads * n_spans
    assert len({r.id for r in recs}) == len(recs)
    by_id = {r.id: r for r in recs}
    for r in recs:
        if r.name == "inner":
            assert by_id[r.parent].name == "outer" and by_id[r.parent].tid == r.tid
        else:
            assert r.parent == -1


def test_clock_brackets_a_record_function(tmp_path, recording):
    """A port span around a record_function brackets it in the exported
    Chrome trace within 1 ms, on the same tid."""
    path = str(tmp_path / "trace.json")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("bench.outer"):
            with record_function("probe.inner"):
                x = torch.randn(64, 64)
                (x @ x).sum()
    prof.export_chrome_trace(path)
    spans.write_into(path, spans.drain())
    events = json.load(open(path))["traceEvents"]
    (outer,) = [e for e in events if e.get("name") == "bench.outer"]
    (inner,) = [e for e in events if e.get("name") == "probe.inner"]
    assert outer["cat"] == "gpt2vl" and outer["ph"] == "X"
    assert outer["tid"] == inner["tid"]
    assert outer["ts"] - 1e3 <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e3


def test_to_chrome_on_a_base():
    r = spans.Span(3, "ce.fwd", 11, 1 << 45, 5_000_000, 5_250_000, 1, 2, {"k": 1})
    (e,) = spans.to_chrome([r], base_ns=1_000_000, pid=9)
    assert e == {"ph": "X", "cat": "gpt2vl", "name": "ce.fwd", "pid": 9, "tid": 11,
                 "ts": 4000.0, "dur": 250.0,
                 "args": {"id": 3, "parent": 1, "step": 2, "pthread": 1 << 45, "k": 1}}


ARCH = dict(block_size=64, vocab_size=300, n_layer=2, n_head=1, n_embd=64)  # hs 64, the kernels'
PER_MICRO = {"step.micro": 1, "step.forward": 1, "step.backward": 1, "linear.fwd": 8,
             "linear.bwd": 8, "attn.fwd": 2, "ce.fwd": 1, "ce.bwd": 1}


@pytest.mark.parametrize("attn_impl,accum_dtype", [("flash", None), ("xla", "bfloat16")])
def test_one_train_step_has_its_spans(recording, attn_impl, accum_dtype):
    """2 layers, width 64, accum 2 on the CPU: each span of the step as
    often as it is placed. ``attn.bwd`` comes from the flash Functions'
    backward (their plain versions here); the plain path's backward is
    autograd's and has none. ``step.fold`` comes with explicit (bf16)
    accumulators only."""
    cfg = GPTConfig(**ARCH)
    torch.manual_seed(0)
    model = gpt2.GPT2(cfg)
    state = adamw_init(gpt2.named_params(model))

    def loss_fn(m, micro):
        return gpt2.loss(m, micro["x"], cfg, targets=micro["y"], policy=FP32_POLICY,
                         attn_impl=attn_impl)

    step = make_train_step(loss_fn, OptimizerConfig(), ScheduleConfig(max_steps=10),
                           decay_mask=gpt2.decay_mask(model), grad_accum_dtype=accum_dtype)
    rows = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 2, 33)).astype(np.uint16)
    batch = split_rows_on_device(torch.from_numpy(rows.view(np.int16)))
    spans.drain()
    step(model, state, batch, 4)
    recs = spans.drain()
    counts = {}
    for r in recs:
        counts[r.name] = counts.get(r.name, 0) + 1
    want = {n: 2 * c for n, c in PER_MICRO.items()}
    want.update({"step": 1, "step.norm": 1, "step.optimizer": 1, "optimizer.kernel": 1})
    if attn_impl == "flash":
        want["attn.bwd"] = 4
    if accum_dtype:
        want["step.fold"] = 2
    assert counts == want
    assert {r.step for r in recs} == {4}
    by_id = {r.id: r for r in recs}
    parent = {r.name: by_id[r.parent].name for r in recs if r.parent in by_id}
    assert parent["step.micro"] == parent["step.norm"] == parent["step.optimizer"] == "step"
    assert parent["step.forward"] == parent["step.backward"] == "step.micro"
    assert parent["optimizer.kernel"] == "step.optimizer"
    assert parent["ce.fwd"] == "step.forward"
    (opt,) = [r for r in recs if r.name == "step.optimizer"]
    # the JAX gate (1024 elements or more, a multiple of 128): wte, wpe and the 4 weights a layer
    assert opt.attrs == {"kernel": 10, "plain": 18, "q8": 0}
    assert {r.attrs["impl"] for r in recs if r.name == "attn.fwd"} == {attn_impl}
    if attn_impl == "flash":
        assert {r.attrs["family"] for r in recs if r.name == "attn.fwd"} == {"self"}


def test_split_rows_has_its_span(recording):
    rows = torch.zeros(2, 3, 5, dtype=torch.int16)
    out = split_rows_on_device(rows)
    assert out["x"].shape == (2, 3, 4)
    assert [r.name for r in spans.drain()] == ["data.split"]


def test_prefetcher_counts_its_waits(recording):
    """wait_s sums the time in next(); the spans of next() lie on the
    caller's thread, those of produce and stage on the producer's."""
    made = []

    def produce():
        time.sleep(0.05)
        made.append(len(made))
        return made[-1]

    pf = HostPrefetcher(produce, depth=1, stage=lambda b: b * 10)
    try:
        t0 = time.perf_counter()
        got = [pf.next() for _ in range(3)]
        spent = time.perf_counter() - t0
    finally:
        pf.close()
    assert got == [0, 10, 20]
    assert 0.05 <= pf.wait_s <= spent
    recs = spans.drain()
    main = threading.get_native_id()
    waits = [r for r in recs if r.name == "data.wait"]
    assert len(waits) == 3 and {r.tid for r in waits} == {main}
    producer = {r.tid for r in recs if r.name in ("data.produce", "data.stage")}
    assert len(producer) == 1 and main not in producer
    assert sum(r.name == "data.stage" for r in recs) >= 3


def test_update_outside_the_step_tags_no_other_span(recording):
    """adamw_update's leaf counts go to a ``step.optimizer`` span alone: a
    caller's own span around it keeps its attrs."""
    torch.manual_seed(0)
    model = gpt2.GPT2(GPTConfig(**ARCH))
    params = gpt2.named_params(model)
    grads = {n: torch.randn_like(p) for n, p in params.items()}
    with spans.span("step.norm"):
        adamw_update(params, grads, adamw_init(params), 1e-3, OptimizerConfig(),
                     norm=global_norm(grads), decay_mask=gpt2.decay_mask(model))
    recs = {r.name: r for r in spans.drain()}
    assert recs["step.norm"].attrs == {}
    assert recs["optimizer.kernel"].parent == recs["step.norm"].id
