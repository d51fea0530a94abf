"""The step's device timeline by the program's own spans.

``profile_spans`` profiles whole steps with the program's spans on
(``gpt2_vision_language_tpu_torch/obs/spans.py``) and torch.profiler on the
device alone (``activities=[CUDA]``: kernels, copies and sets, and the CUDA
runtime and driver calls that launched them, each with its host time, its
thread and a correlation id; no host ops). As in ``trace.profile_device`` a
one-element fill marks each end of the window; each fill is launched inside a
span ``bench.mark``, so the first one shows the two clocks side by side.

``reduce_spans`` gives the window's device time to the spans:

  * a device op goes to the innermost span open on its launch's thread at
    the launch's host time (launch and op matched by correlation id). A
    launch on a thread with no span open then (autograd's device thread
    outside the linears, the attention and the CE) goes to the innermost
    span open at that time on the thread that runs the ``step`` spans;
  * busy time is the union of the ops: where ops overlap, the one that
    started first holds the time;
  * an idle gap of that union goes to the span of the op that ends it;
    the span open on the step's thread when the gap began goes in its label.

Σ over spans of (self busy + self idle) + the unattributed time is the
window. ``METRICS`` holds the per-layer readers of the result (five
functions of a run record), none of which matches a kernel's name.
"""

from __future__ import annotations

import os
import sys

from . import manifest
from .trace import DEVICE_CATS, load_chrome_trace

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPAN_CAT = "gpt2vl"
MARK = "bench.mark"
STEP = "step"
TOP = 10
ITEMSIZE = {"bf16": 2, "fp16": 2, "fp32": 4}


def _corr(e):
    return (e.get("args") or {}).get("correlation")


def pthread_tids(pthread: int) -> tuple:
    """The ``tid``s a device-only torch.profiler trace gives the launches of
    the thread whose ``threading.get_ident()`` is ``pthread``: its low 32
    bits, or their magnitude as a signed number."""
    low = pthread & 0xFFFFFFFF
    return (low, (1 << 32) - low) if low >= 1 << 31 else (low,)


class _Spans:
    """The program's spans of one Chrome trace: the innermost one open on a
    thread at a moment, by a sweep over sorted times. A launch's ``tid`` is
    the thread's system id where the profile records host ops, else one of
    ``pthread_tids`` of the span's ``pthread``."""

    def __init__(self, events: list):
        self.spans = [e for e in events if e.get("ph") == "X" and e.get("cat") == SPAN_CAT]
        self.by_tid, self.alias = {}, {}
        for i, e in enumerate(self.spans):
            self.by_tid.setdefault(e["tid"], []).append((e["ts"], e["ts"] + e["dur"], i))
            for t in pthread_tids(e["args"].get("pthread", 0)):
                self.alias[t] = e["tid"]
        for lst in self.by_tid.values():
            lst.sort(key=lambda s: (s[0], -s[1]))
        steps = {}
        for e in self.spans:
            if e["name"] == STEP:
                steps[e["tid"]] = steps.get(e["tid"], 0) + 1
        self.step_tid = max(steps, key=steps.get) if steps else None

    def innermost(self, tid, times: list) -> list:
        """For each time of ``times`` (sorted), the index of the innermost
        span open on thread ``tid`` then (start <= t < end), or None."""
        spans, out, stack, j = self.by_tid.get(tid, []), [], [], 0
        for t in times:
            while j < len(spans) and spans[j][0] <= t:
                while stack and stack[-1][1] <= spans[j][0]:
                    stack.pop()
                stack.append(spans[j])
                j += 1
            while stack and stack[-1][1] <= t:
                stack.pop()
            out.append(stack[-1][2] if stack else None)
        return out

    def thread(self, tid):
        """The system id of the thread whose launches carry ``tid``, or None."""
        if tid in self.by_tid:
            return tid
        return self.alias.get(tid)

    def at(self, queries: list) -> list:
        """[(tid, t)] of launches -> the span index for each: the innermost
        open on the launch's thread, else on the step thread, else None; and
        whether it came from the step thread."""
        queries = [(self.thread(tid), t) for tid, t in queries]
        out = [None] * len(queries)
        via = [False] * len(queries)
        for tid, idx in _group(queries).items():
            idx.sort(key=lambda i: queries[i][1])
            got = self.innermost(tid, [queries[i][1] for i in idx])
            miss = []
            for i, g in zip(idx, got):
                out[i] = g
                if g is None:
                    miss.append(i)
            if miss and self.step_tid is not None and tid != self.step_tid:
                for i, g in zip(miss, self.innermost(self.step_tid,
                                                     [queries[i][1] for i in miss])):
                    out[i], via[i] = g, g is not None
        return out, via


def _group(queries):
    groups = {}
    for i, (tid, _) in enumerate(queries):
        groups.setdefault(tid, []).append(i)
    return groups


def reduce_spans(events: list, steps: int) -> dict:
    """The device time of the window from the first device op to the last,
    both launched inside a ``bench.mark`` span where there are two (the
    markers), given to the program's spans (every span of the
    trace: ``profile_spans`` records those of its steps alone); every time
    per step except ``window_us`` and ``busy_us``."""
    ops = [(e["ts"], e["ts"] + e.get("dur", 0.0), _corr(e)) for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    launch = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS and _corr(e) is not None:
            launch[_corr(e)] = (e["tid"], e["ts"])
    sp = _Spans(events)
    inside = [(m["tid"], m["ts"], m["ts"] + m["dur"]) for m in sp.spans if m["name"] == MARK]
    marks = [(s, e) for s, e, c in ops if c in launch
             and any(tid == launch[c][0] and a <= launch[c][1] < b for tid, a, b in inside)]
    recorded = len(ops)
    if len(marks) >= 2:  # an upload of the producer's before or after them is left out
        lo, hi = min(marks)[0], max(marks)[1]
        ops = [o for o in ops if o[0] >= lo and o[1] <= hi]
    if len(ops) < 3:
        raise RuntimeError("the profiler recorded no device activity between the markers")
    ops.sort(key=lambda o: (o[0], o[1]))
    lo, hi = ops[0][0], max(e for _, e, _ in ops)
    known = [i for i, op in enumerate(ops) if op[2] in launch]
    owner = [None] * len(ops)
    via = [False] * len(ops)
    threads = {"system": 0, "pthread": 0, "unknown": 0}
    for i in known:
        tid = launch[ops[i][2]][0]
        threads["system" if tid in sp.by_tid else "pthread" if tid in sp.alias else "unknown"] += 1
    got, from_step = sp.at([launch[ops[i][2]] for i in known])
    for i, g, v in zip(known, got, from_step):
        owner[i], via[i] = g, v

    busy, idle, n_launch = {}, {}, {}
    unattr_busy = unattr_idle = via_step = 0.0
    gaps = []
    cursor = lo
    for (s, e, _), o, v in zip(ops, owner, via):
        if o is not None:
            n_launch[o] = n_launch.get(o, 0) + 1
        if s > cursor:
            gaps.append((cursor, s, o))
            if o is None:
                unattr_idle += s - cursor
            else:
                idle[o] = idle.get(o, 0.0) + (s - cursor)
        if e > cursor:
            t = e - max(s, cursor)
            if o is None:
                unattr_busy += t
            else:
                busy[o] = busy.get(o, 0.0) + t
                via_step += t if v else 0.0
            cursor = e
    busy_us = sum(busy.values()) + unattr_busy

    names = {}
    parent = {e["args"]["id"]: e["args"]["parent"] for e in sp.spans}
    by_id = {e["args"]["id"]: i for i, e in enumerate(sp.spans)}
    total = {}
    for i, e in enumerate(sp.spans):
        r = names.setdefault(e["name"], {"count": 0, "host_us": 0.0, "self_busy_us": 0.0,
                                         "self_idle_us": 0.0, "total_busy_us": 0.0,
                                         "total_idle_us": 0.0, "launches": 0})
        r["count"] += 1
        r["host_us"] += e["dur"]
        r["self_busy_us"] += busy.get(i, 0.0)
        r["self_idle_us"] += idle.get(i, 0.0)
        r["launches"] += n_launch.get(i, 0)
        # the time of this span and of everything under it on its thread
        seen, sid = set(), e["args"]["id"]
        while sid in by_id and sid not in seen:
            seen.add(sid)
            j = by_id[sid]
            name = sp.spans[j]["name"]
            total.setdefault(name, [0.0, 0.0])
            total[name][0] += busy.get(i, 0.0)
            total[name][1] += idle.get(i, 0.0)
            sid = parent.get(sid, -1)
    for name, (b, d) in total.items():
        names[name]["total_busy_us"], names[name]["total_idle_us"] = b, d
    for r in names.values():
        for k in r:
            r[k] /= steps

    step_at = sp.innermost(sp.step_tid, [g[0] for g in gaps])

    def label(i):
        return "no span" if i is None else sp.spans[i]["name"]

    longest = sorted(zip(gaps, step_at), key=lambda x: x[0][0] - x[0][1])[:TOP]
    mark = None
    marked = [i for i, o in enumerate(owner) if o is not None and sp.spans[o]["name"] == MARK]
    if marked:
        first, m = ops[marked[0]], sp.spans[owner[marked[0]]]
        ts = launch[first[2]][1]
        mark = {"launch_after_span_start_us": ts - m["ts"], "span_us": m["dur"],
                "op_after_launch_us": first[0] - ts}
    return {"window_us": hi - lo, "busy_us": busy_us, "steps": steps, "spans": names,
            "unattributed_busy_us": unattr_busy / steps,
            "unattributed_idle_us": unattr_idle / steps,
            "coverage": (busy_us - unattr_busy) / busy_us if busy_us else 0.0,
            "via_step_thread_busy_us": via_step / steps,
            "launches_matched": len(known), "device_ops": len(ops),
            "outside_markers": recorded - len(ops), "launch_threads": threads,
            "gaps": [[f"{label(g[2])} < {label(s)}", g[1] - g[0]] for g, s in longest],
            "mark": mark}


def closure(r: dict) -> float:
    """(Σ self busy + self idle + unattributed) × steps over the window: 1
    when every moment of the window is given once."""
    per_step = sum(s["self_busy_us"] + s["self_idle_us"] for s in r["spans"].values())
    per_step += r["unattributed_busy_us"] + r["unattributed_idle_us"]
    return per_step * r["steps"] / r["window_us"]


def report(r: dict, out=sys.stderr) -> None:
    """The ten spans that hold the most device time, with the coverage."""
    top = sorted(r["spans"].items(), key=lambda kv: -(kv[1]["self_busy_us"]
                                                      + kv[1]["self_idle_us"]))[:TOP]
    step_us = r["window_us"] / r["steps"]
    print(f"[spans] {r['steps']} steps, {step_us * 1e-3:.3f} ms a step, busy "
          f"{r['busy_us'] / r['window_us']:.4%}; busy given to a span {r['coverage']:.4%} "
          f"({r['via_step_thread_busy_us'] * 1e-3:.3f} ms a step through the step's thread); "
          f"window closure {closure(r):.6f}", file=out)
    for name, s in top:
        print(f"[spans] {name:18s} busy {s['self_busy_us'] * 1e-3:9.3f} ms  idle "
              f"{s['self_idle_us'] * 1e-3:8.3f} ms  count {s['count']:7.1f}  launches "
              f"{s['launches']:8.1f}  host {s['host_us'] * 1e-3:9.3f} ms", file=out)
    print(f"[spans] unattributed busy {r['unattributed_busy_us'] * 1e-3:.3f} ms idle "
          f"{r['unattributed_idle_us'] * 1e-3:.3f} ms a step", file=out)


def profile_spans(run_steps, steps: int, path: str):
    """Profile ``run_steps()`` (``steps`` whole steps) on the device alone
    with the program's spans on, and reduce it (``reduce_spans``); None for a
    program without spans. The Chrome trace, with the spans in it, goes to
    ``path`` and is removed once read. A profile that matches no launch to a
    device op raises: its timeline could not be given to the spans."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    try:
        from gpt2_vision_language_tpu_torch.obs import spans as port
    except ImportError:
        return None
    mark = torch.empty(1, device="cuda")
    port.enable()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            with port.span(MARK):
                mark.zero_()
            run_steps()
            torch.cuda.synchronize()
            with port.span(MARK):
                mark.zero_()
            torch.cuda.synchronize()
    finally:
        port.disable()
        records = port.drain()
    prof.export_chrome_trace(path)
    try:
        port.write_into(path, records)
        events = load_chrome_trace(path)
    finally:
        os.remove(path)
    red = reduce_spans(events, steps)
    if red["launches_matched"] == 0:
        raise RuntimeError("the device-only profile matched no launch to a device op")
    return red


# ---------------------------------------------------------------------------
# Per-layer readers of a run record whose trace holds the spans' reduction
# (``rec.trace["spans"]``) and whose window holds the program's own counter
# (``rec.window["data_wait_s"]``); each returns None where it finds nothing.
# ---------------------------------------------------------------------------


def _given(run, *names, total: bool = False):
    """The device time a step (s) given to the spans ``names``: self busy +
    self idle, or with ``total`` that of the spans under them too."""
    trace = getattr(run, "trace", None) or {}
    found = trace.get("spans")
    if not found:
        return None
    b, d = ("total_busy_us", "total_idle_us") if total else ("self_busy_us", "self_idle_us")
    us = sum(found[n][b] + found[n][d] for n in names if n in found)
    return us * 1e-6 if us > 0 else None


def _bound(ops: float, nbytes: float, run) -> float:
    return max(ops / run.peaks["flops"][run.compute], nbytes / run.peaks["bytes_per_s"])


def data_wait_ms(run):
    """The program's ``HostPrefetcher.wait_s`` over the window, a mean per
    window step, in ms."""
    w = getattr(run, "window", None) or {}
    if "data_wait_s" not in w or not w.get("steps"):
        return None
    return 1e3 * w["data_wait_s"] / w["steps"]


def optimizer_ms(run):
    """The device time a step given to ``step.optimizer`` and the spans under
    it (``optimizer.kernel``), busy and idle, in ms."""
    s = _given(run, "step.optimizer", total=True)
    return None if s is None else 1e3 * s


def linear_work(n: int, c: int, itemsize: int) -> list:
    """[(operations, bytes)] of a block's four linears over n rows at width c
    for one micro-batch, forward and backward: 2·n·in·out operations forward
    and twice that backward; x, w, y, dx and dw once."""
    out = []
    for k_in, k_out in ((c, 3 * c), (c, c), (c, 4 * c), (4 * c, c)):
        out.append((3 * 2 * n * k_in * k_out,
                    itemsize * (2 * n * k_in + n * k_out + 2 * k_in * k_out)))
    return out


def linear_roofline(run):
    """The linears' least time over the device time given to ``linear.fwd``
    and ``linear.bwd``, in %: casts and bias adds are in that time."""
    spent = _given(run, "linear.fwd", "linear.bwd")
    if spent is None or not run.peaks:
        return None
    d, tr = run.dims, run.traffic
    work = linear_work(tr["micro_batch_size"] * tr["seq_len"], d["n_embd"],
                       ITEMSIZE[run.compute])
    bound = d["n_layer"] * tr["grad_accum_steps"] * sum(_bound(o, b, run) for o, b in work)
    return 100.0 * bound / spent


def attn_roofline(run):
    """The attention's least time (``attn_fwd_roofline.forward_work`` and
    ``attn_bwd_roofline.backward_work``) over the device time given to
    ``attn.fwd`` and ``attn.bwd``, wrapper copies included, in %."""
    spent = _given(run, "attn.fwd", "attn.bwd")
    if spent is None or not run.peaks:
        return None
    d, tr = run.dims, run.traffic
    args = (tr["micro_batch_size"], d["n_head"], tr["seq_len"], d["n_embd"] // d["n_head"],
            ITEMSIZE[run.compute])
    fwd = manifest.load_module("metrics", "attn_fwd_roofline").forward_work(*args)
    bwd = manifest.load_module("metrics", "attn_bwd_roofline").backward_work(*args)
    bound = d["n_layer"] * tr["grad_accum_steps"] * (_bound(*fwd, run) + _bound(*bwd, run))
    return 100.0 * bound / spent


def ce_work(n: int, v: int, c: int, itemsize: int) -> tuple:
    """(operations, bytes) of one micro-batch's CE: the logits, dx and dw
    products, 6·n·v·c (the backward's recompute of the logits not counted);
    x, w, dx and dw once, the int32 targets and the fp32 nll."""
    return 6 * n * v * c, itemsize * (2 * n * c + 2 * v * c) + 8 * n


def ce_roofline(run):
    """The CE's least time over the device time given to ``ce.fwd`` and
    ``ce.bwd``, in %."""
    spent = _given(run, "ce.fwd", "ce.bwd")
    if spent is None or not run.peaks:
        return None
    d, tr = run.dims, run.traffic
    ops, nbytes = ce_work(tr["micro_batch_size"] * tr["seq_len"], d["vocab_pad"], d["n_embd"],
                          ITEMSIZE[run.compute])
    return 100.0 * tr["grad_accum_steps"] * _bound(ops, nbytes, run) / spent


METRICS = {"data_wait_ms": data_wait_ms, "optimizer_ms": optimizer_ms,
           "linear_roofline": linear_roofline, "attn_roofline": attn_roofline,
           "ce_roofline": ce_roofline}
