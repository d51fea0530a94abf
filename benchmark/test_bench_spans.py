"""The reduction of a spans pass (harness/spans.py) on a hand-written Chrome
trace, and the five span metrics on fake run records."""

import json
import subprocess
import sys
from types import SimpleNamespace

import pytest

from harness import manifest
from harness import spans as sp


def _x(name, cat, ts, dur, tid, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "pid": 1,
            "args": args}


PTHREAD = {1: (5 << 32) | 1000, 2: (7 << 32) | 0xFFFFFF00, 3: 9 << 32}


def _span(name, ts, end, tid, sid, parent=-1):
    return _x(name, "gpt2vl", ts, end - ts, tid, id=sid, parent=parent, step=0,
              pthread=PTHREAD[tid])


def _events():
    """Thread 1 runs the step, 2 is autograd's, 3 the producer; correlation
    9 has no launch, the copy of 4 lies under the kernel of 3, and the
    producer's copy 10 comes after the second marker. Launches 2 and 7 carry
    thread 1's pthread id, 5 and 6 thread 2's as a negative number's
    magnitude (256), as a device-only profile gives them."""
    spans = [
        _span("bench.mark", 0, 2, 1, 0),
        _span("step", 5, 95, 1, 1),
        _span("step.micro", 6, 60, 1, 2, 1),
        _span("step.forward", 7, 30, 1, 3, 2),
        _span("linear.fwd", 8, 12, 1, 4, 3),
        _span("data.stage", 20, 25, 3, 5),
        _span("step.backward", 30, 60, 1, 6, 2),
        _span("linear.bwd", 35, 40, 2, 7),
        _span("step.optimizer", 62, 90, 1, 8, 1),
        _span("optimizer.kernel", 70, 75, 1, 9, 8),
        _span("bench.mark", 96, 98, 1, 10),
    ]
    launches = [(1, 1, 1), (2, 1000, 9), (3, 1, 15), (4, 3, 21), (5, 256, 36), (6, 256, 45),
                (7, 1000, 72), (8, 1, 97), (10, 3, 99)]
    calls = [_x("cudaLaunchKernel", "cuda_runtime", ts, 0.5, tid, correlation=c)
             for c, tid, ts in launches]
    ops = [("kernel", 1, 10, 11), ("kernel", 2, 12, 20), ("kernel", 3, 20, 30),
           ("gpu_memcpy", 4, 25, 28), ("kernel", 5, 40, 50), ("kernel", 6, 55, 60),
           ("kernel", 7, 80, 85), ("kernel", 9, 86, 88), ("gpu_memset", 8, 100, 101),
           ("gpu_memcpy", 10, 102, 104)]
    dev = [_x(f"op{c}", cat, s, e - s, 7, correlation=c) for cat, c, s, e in ops]
    return spans + calls + dev


def test_reduction_by_hand():
    r = sp.reduce_spans(_events(), 1)
    assert r["window_us"] == 91 and r["busy_us"] == 42
    s = r["spans"]
    self_ = {n: (v["self_busy_us"], v["self_idle_us"]) for n, v in s.items()}
    assert self_ == {"bench.mark": (2, 12), "step": (0, 0), "step.micro": (0, 0),
                     "step.forward": (10, 0), "linear.fwd": (8, 1), "data.stage": (0, 0),
                     "step.backward": (5, 5), "linear.bwd": (10, 10),
                     "step.optimizer": (0, 0), "optimizer.kernel": (5, 20)}
    assert (r["unattributed_busy_us"], r["unattributed_idle_us"]) == (2, 1)
    assert sum(a + b for a, b in self_.values()) + 2 + 1 == r["window_us"]
    assert sp.closure(r) == pytest.approx(1.0, abs=1e-12)
    assert r["coverage"] == pytest.approx(40 / 42)
    assert r["via_step_thread_busy_us"] == 5  # autograd's launch outside a span
    assert (s["step.optimizer"]["total_busy_us"], s["step.optimizer"]["total_idle_us"]) == (5, 20)
    assert (s["step.micro"]["total_busy_us"], s["step.micro"]["total_idle_us"]) == (23, 6)
    assert (s["step"]["total_busy_us"], s["step"]["total_idle_us"]) == (28, 26)
    assert s["bench.mark"]["count"] == 2 and s["data.stage"]["launches"] == 1
    assert s["linear.fwd"]["host_us"] == 4
    assert r["gaps"][:3] == [["optimizer.kernel < step", 20], ["bench.mark < step.optimizer", 12],
                             ["linear.bwd < step.backward", 10]]
    assert r["mark"] == {"launch_after_span_start_us": 1, "span_us": 2, "op_after_launch_us": 9}
    assert (r["launches_matched"], r["device_ops"], r["outside_markers"]) == (8, 9, 1)
    assert r["launch_threads"] == {"system": 4, "pthread": 4, "unknown": 0}


def test_reduction_without_markers():
    """Without two marker launches the window runs from the first op to the
    last, the producer's late copy included."""
    events = [e for e in _events() if e["name"] != "bench.mark"]
    r = sp.reduce_spans(events, 1)
    assert (r["window_us"], r["outside_markers"], r["device_ops"]) == (94, 0, 10)
    assert r["mark"] is None
    assert sp.closure(r) == pytest.approx(1.0, abs=1e-12)


def test_pthread_tids():
    assert sp.pthread_tids((5 << 32) | 1000) == (1000,)
    assert sp.pthread_tids((7 << 32) | 0xFFFFFF00) == (0xFFFFFF00, 256)


def test_reduction_per_step():
    r1, r2 = sp.reduce_spans(_events(), 1), sp.reduce_spans(_events(), 2)
    assert r2["window_us"] == r1["window_us"]
    assert r2["spans"]["linear.bwd"]["self_idle_us"] == 5
    assert r2["unattributed_idle_us"] == 0.5
    assert sp.closure(r2) == pytest.approx(1.0, abs=1e-12)


def test_report_prints_the_top(capsys):
    sp.report(sp.reduce_spans(_events(), 1), out=sys.stdout)
    out = capsys.readouterr().out
    assert "busy given to a span 95.2381%" in out
    assert out.index("optimizer.kernel") < out.index("linear.fwd")


def _run(spans=None, **window):
    dims = {"n_layer": 12, "n_head": 12, "n_embd": 768, "vocab_pad": 50304}
    traffic = {"micro_batch_size": 16, "seq_len": 1024, "grad_accum_steps": 4}
    trace = None if spans is None else {"spans": spans}
    return SimpleNamespace(dims=dims, traffic=traffic, compute="bf16", trace=trace,
                           peaks={"flops": {"bf16": 1e15}, "bytes_per_s": 1e12},
                           window=window or None)


def _t(busy, idle=0.0, total=None):
    return {"self_busy_us": busy, "self_idle_us": idle, "total_busy_us": total or busy,
            "total_idle_us": idle}


def test_metrics_read_nothing_without_spans():
    run = _run()
    assert {k: f(run) for k, f in sp.METRICS.items()} == dict.fromkeys(sp.METRICS)
    assert sp.data_wait_ms(_run(steps=4)) is None


def test_data_wait_ms():
    assert sp.data_wait_ms(_run(steps=4, data_wait_s=0.002)) == pytest.approx(0.5)


def test_optimizer_ms_takes_its_children():
    run = _run({"step.optimizer": {**_t(100.0, 900.0), "total_busy_us": 4100.0,
                                   "total_idle_us": 2900.0}, "optimizer.kernel": _t(4000.0)})
    assert sp.optimizer_ms(run) == pytest.approx(7.0)


def test_linear_roofline():
    n, c = 16 * 1024, 768
    ops = 3 * 2 * n * 12 * c * c  # the four linears: 3C + C + 4C + 4C products of width C
    assert sum(o for o, _ in sp.linear_work(n, c, 2)) == ops
    bytes_qkv = 2 * (2 * n * c + n * 3 * c + 2 * 3 * c * c)
    assert sp.linear_work(n, c, 2)[0][1] == bytes_qkv
    run = _run({"linear.fwd": _t(30e3, 2e3), "linear.bwd": _t(60e3, 8e3)})
    bound = 12 * 4 * sum(max(o / 1e15, b / 1e12) for o, b in sp.linear_work(n, c, 2))
    assert sp.linear_roofline(run) == pytest.approx(100 * bound / 0.1)


def test_attn_roofline_reuses_the_attention_work():
    fwd = manifest.load_module("metrics", "attn_fwd_roofline").forward_work(16, 12, 1024, 64, 2)
    bwd = manifest.load_module("metrics", "attn_bwd_roofline").backward_work(16, 12, 1024, 64, 2)
    run = _run({"attn.fwd": _t(10e3), "attn.bwd": _t(30e3, 10e3)})
    bound = 48 * (max(fwd[0] / 1e15, fwd[1] / 1e12) + max(bwd[0] / 1e15, bwd[1] / 1e12))
    assert sp.attn_roofline(run) == pytest.approx(100 * bound / 0.05)


def test_ce_roofline():
    n, v, c = 16 * 1024, 50304, 768
    assert sp.ce_work(n, v, c, 2) == (6 * n * v * c, 2 * (2 * n * c + 2 * v * c) + 8 * n)
    run = _run({"ce.fwd": _t(10e3), "ce.bwd": _t(30e3)})
    # 6 N V C at 989 TFLOP/s: 15.4 ms a step for 4 micro-batches
    assert 4 * 6 * n * v * c / 989e12 == pytest.approx(15.4e-3, rel=0.01)
    assert sp.ce_roofline(run) == pytest.approx(100 * 4 * 6 * n * v * c / 1e15 / 0.04)


def test_harness_spans_imports_nothing_of_the_program():
    code = (f"import sys; sys.path[:0] = [{str(manifest.BENCH_DIR)!r}]; "
            "import harness.spans, spans_pass, json; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=manifest.ROOT)
    assert out.returncode == 0, out.stderr
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert "gpt2_vision_language_tpu_torch" not in mods and "jax" not in mods
