"""Reduction of torch.profiler traces to what the per-layer readers take.

Three profiles follow a traced run's window, each of whole steps:

  * ``profile_device``: the device alone (CUDA activity, no host ops, so the
    host runs near its unprofiled pace), between two marker launches that
    open and close the span: every device activity (``kernel``,
    ``gpu_memcpy``, ``gpu_memset``), their union (the busy time) over the
    span, and the device time by kernel name;
  * ``profile_host``: the host ops too, inside a ``bench.window`` span: the
    longest idle gaps of the device, each labelled with the benchmark span
    and the innermost host op open on the main thread when it began (host
    op recording slows the host, so these gaps are longer than unprofiled);
  * ``profile_shapes``: with ``record_shapes``, the product ops (``aten::mm``
    and its kin) with their input shapes and own device time
    (``key_averages(group_by_input_shape=True)``).

Each goes through its Chrome trace (``export_chrome_trace``), whose events
carry their category and thread on one clock.
"""

from __future__ import annotations

import bisect
import json
import os

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "bench.window"
TOP = 10  # entries of each list of the breakdown
MM_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm", "aten::_addmm_activation")


def load_chrome_trace(path: str) -> list:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def merge(intervals) -> list:
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def clip(intervals, lo: float, hi: float) -> list:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def gaps(merged, lo: float, hi: float) -> list:
    """The idle (start, end) intervals of [lo, hi] between merged busy ones."""
    out, cur = [], lo
    for s, e in merged:
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        out.append((cur, hi))
    return out


class HostSpans:
    """The main thread's host ops and spans, to say what the host was doing
    at a moment: the outermost ``bench.`` span and the innermost op open."""

    LOOKBACK = 4000  # ops before the moment searched for the innermost open one

    def __init__(self, events: list, tid):
        ops = [(e["ts"], e["ts"] + e.get("dur", 0.0), e["name"]) for e in events
               if e.get("ph") == "X" and e.get("tid") == tid
               and e.get("cat") in ("cpu_op", "user_annotation")]
        self.ops = sorted(ops, key=lambda x: x[0])
        self.starts = [o[0] for o in self.ops]
        self.bench = [o for o in self.ops if o[2].startswith("bench.") and o[2] != WINDOW_SPAN]

    def label(self, t: float) -> str:
        i = bisect.bisect_right(self.starts, t)
        open_ = [o for o in self.ops[max(0, i - self.LOOKBACK):i] if o[1] > t]
        if not open_:
            return "host: no op open"
        bench = [o for o in self.bench if o[0] <= t < o[1]]
        inner = min(open_, key=lambda o: o[1] - o[0])
        head = bench[0][2] if bench else "outside the benchmark's spans"
        return head if inner[2] == head else f"{head} > {inner[2]}"


def device_activity(events: list) -> list:
    return [(e["name"], e["ts"], e["ts"] + e.get("dur", 0.0)) for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def busy(dev: list, lo: float, hi: float) -> tuple:
    """(busy time, merged busy intervals, {name: time}) of the device
    activity ``dev`` inside [lo, hi]."""
    dev = [(n, s, t) for n, s, t in dev if t > lo and s < hi]
    if not dev:
        raise RuntimeError("the profiler recorded no device activity in the window")
    merged = merge(clip([(s, t) for _, s, t in dev], lo, hi))
    by_name = {}
    for n, s, t in dev:
        by_name[n] = by_name.get(n, 0.0) + (min(t, hi) - max(s, lo))
    return sum(e - s for s, e in merged), merged, by_name


def reduce_device(events: list, steps: int) -> dict:
    """The device's activity between the first and the last event (the two
    markers): {"window_us", "busy_us", "steps", "by_name": {name: us}}."""
    dev = device_activity(events)
    if len(dev) < 3:
        raise RuntimeError("the profiler recorded no device activity between the markers")
    lo, hi = min(s for _, s, _ in dev), max(t for _, _, t in dev)
    total, _, by_name = busy(dev, lo, hi)
    return {"window_us": hi - lo, "busy_us": total, "steps": steps, "by_name": by_name}


def reduce_host(events: list) -> list:
    """[(label, us)] of the longest idle gaps of the device inside the
    ``bench.window`` span, longest first."""
    spans = [e for e in events if e.get("name") == WINDOW_SPAN and e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    if len(spans) != 1:
        raise RuntimeError(f"the trace holds {len(spans)} host spans {WINDOW_SPAN!r}, not 1")
    lo, hi = spans[0]["ts"], spans[0]["ts"] + spans[0]["dur"]
    _, merged, _ = busy(device_activity(events), lo, hi)
    host = HostSpans(events, spans[0].get("tid"))
    longest = sorted(gaps(merged, lo, hi), key=lambda g: g[0] - g[1])[:TOP]
    return [(host.label(s), e - s) for s, e in longest]


def _chrome(prof, path: str) -> list:
    prof.export_chrome_trace(path)
    try:
        return load_chrome_trace(path)
    finally:
        os.remove(path)


def profile_device(run_steps, steps: int, path: str) -> dict:
    """Profile the device alone over ``run_steps()`` (``steps`` whole steps),
    synchronised and marked by a one-element fill at both ends; the Chrome
    trace goes to ``path`` and is removed once read."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    mark = torch.empty(1, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _sync(torch)
        mark.zero_()
        run_steps()
        _sync(torch)
        mark.zero_()
        _sync(torch)
    return reduce_device(_chrome(prof, path), steps)


def profile_host(run_step, path: str) -> list:
    """The labelled idle gaps of ``run_step()``, profiled with the host's ops
    inside the window span."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            _sync(torch)
            run_step()
            _sync(torch)
    return reduce_host(_chrome(prof, path))


def _sync(torch):
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _matrices(shapes) -> list:
    return [list(s) for s in shapes if isinstance(s, (list, tuple)) and len(s) in (2, 3)]


def mm_ops(key_averages) -> list:
    """[{"name", "shapes", "count", "device_us"}] of the product ops, from
    ``key_averages(group_by_input_shape=True)``."""
    out = []
    for ev in key_averages:
        if ev.key not in MM_OPS:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        out.append({"name": ev.key, "shapes": _matrices(ev.input_shapes or []),
                    "count": int(ev.count), "device_us": float(us)})
    return out


def profile_shapes(run_step) -> list:
    """The product ops of one step, profiled apart with ``record_shapes``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        _sync(torch)
        run_step()
        _sync(torch)
    return mm_ops(prof.key_averages(group_by_input_shape=True))
