"""In-memory spans of the port's own work, on the clock of torch.profiler's
device trace.

``span(name, **attrs)`` is a context manager around one piece of work (the
train step's phases, the data pipeline, a linear, an attention, the CE, the
optimizer). Off, the default, it returns one shared no-op object after one
test of a module flag: no record is made and no clock is read. After
``enable()`` each span, when it closes, appends one ``Span`` record to a list
in memory:

  * ``id`` and ``parent``: the span's number and that of the innermost span
    open on the same thread when it opened (-1 for none). Nesting is per
    thread: a span opened on autograd's device thread has no parent on the
    thread that called ``backward()``;
  * ``tid``: ``threading.get_native_id()``, the ``tid`` torch.profiler gives
    the host ops of that thread;
  * ``pthread``: ``threading.get_ident()``. A profile of the device alone
    (``activities=[CUDA]``) gives the CUDA runtime's launch events the low
    32 bits of this id as their ``tid`` (as a signed number's magnitude), not
    the thread's system id;
  * ``start_ns``, ``end_ns``: Unix nanoseconds, ``time.perf_counter_ns()``
    plus the offset to ``time.time_ns()`` taken at ``enable()``: the clock of
    a torch.profiler Chrome trace, whose ``baseTimeNanoseconds`` + ``ts``
    (µs) is Unix time;
  * ``step``: the index of the train step whose ``step_span`` was opened
    last (-1 before any), shared by every span of that step on any thread
    (a producer thread's spans carry the step that was running);
  * ``attrs``: the keyword arguments, and what ``annotate`` added.

``drain()`` hands the records out and clears the list; ``to_chrome`` turns
them into Chrome ``"X"`` events (``cat: "gpt2vl"``) on a trace's clock, and
``write_into`` appends them to a Chrome trace written by torch.profiler, so
the spans lie beside the kernels in one file (``obs/csvlog.ProfilerHook``).
Nothing is written to disk unless ``write_into`` is called.

Where the spans are (the ``layer`` names of ``PERF.md`` section 3):

  * host data: ``data.wait`` (``data/pipeline.HostPrefetcher.next``),
    ``data.produce`` and ``data.stage`` (its producer thread's read and
    upload), ``data.split`` (``train/pretrain.split_rows_on_device``);
  * train step (``train/step.make_train_step``): ``step`` (attr ``step``),
    ``step.micro`` (attr ``i``), ``step.forward`` (``loss_fn``),
    ``step.backward`` (``loss.backward()``), ``step.fold`` (the explicit
    accumulators), ``step.norm`` (the global norm, ``grad_sync`` and the
    step's one host read), ``step.optimizer`` (``adamw_update``; attrs
    ``kernel``, ``plain`` and ``q8``, the leaves of each update),
    ``optimizer.kernel`` (``fused_adamw`` with its leaf table's copy);
  * matmuls: ``linear.fwd``, ``linear.bwd`` (``ops/layers._Linear``);
  * kernels: ``attn.fwd`` (``ops/attention.sdpa``; attrs ``impl`` and, on
    the flash path, ``family``), ``attn.bwd`` (the backward of the flash
    Functions; the plain path's backward is autograd's and has none);
  * model: ``ce.fwd``, ``ce.bwd`` (``ops/fused_ce._LinearCE``).
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import NamedTuple

CATEGORY = "gpt2vl"


class Span(NamedTuple):
    """One closed span; the fields are those the module's docstring lists."""

    id: int
    name: str
    tid: int
    pthread: int
    start_ns: int
    end_ns: int
    parent: int
    step: int
    attrs: dict


class _Noop:
    """The span handed out while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()

_on = False
_records: list = []
_ids = itertools.count()
_offset_ns = 0
_step = -1
_local = threading.local()
_now = time.perf_counter_ns


class _Thread:
    """A thread's two ids and its open spans, innermost last."""

    __slots__ = ("tid", "pthread", "open")

    def __init__(self):
        self.tid, self.pthread, self.open = threading.get_native_id(), threading.get_ident(), []


def _thread() -> _Thread:
    th = getattr(_local, "th", None)
    if th is None:
        th = _local.th = _Thread()
    return th


class _Span:
    __slots__ = ("name", "attrs", "index", "id", "parent", "step", "thread", "start")

    def __init__(self, name: str, attrs: dict, index=None):
        self.name, self.attrs, self.index = name, attrs, index

    def __enter__(self):
        global _step
        if self.index is not None:
            _step = self.index
        th = self.thread = _thread()
        self.parent = th.open[-1].id if th.open else -1
        self.id = next(_ids)
        self.step = _step
        th.open.append(self)
        self.start = _now()
        return self

    def __exit__(self, *exc):
        end = _now()
        th = self.thread
        th.open.pop()
        _records.append(Span(self.id, self.name, th.tid, th.pthread, self.start + _offset_ns,
                             end + _offset_ns, self.parent, self.step, self.attrs))
        return False


def span(name: str, **attrs):
    """A context manager around a piece of work: the shared no-op object while
    recording is off, a recorded span while it is on."""
    if not _on:
        return NOOP
    return _Span(name, attrs)


def step_span(index: int):
    """The span of one train step (``step``, attr ``step``): the spans opened
    while it is the last step opened carry ``index`` as their step."""
    if not _on:
        return NOOP
    return _Span("step", {"step": index}, index)


def annotate(name: str, **attrs) -> None:
    """Add ``attrs`` to the innermost span called ``name`` open on this thread
    (nothing while recording is off, or with no such span open)."""
    if not _on:
        return
    for s in reversed(_thread().open):
        if s.name == name:
            s.attrs.update(attrs)
            return


def enabled() -> bool:
    """Whether spans are being recorded."""
    return _on


def enable() -> None:
    """Turn recording on, and take the offset from ``perf_counter_ns`` to Unix
    time: the pair read closest together of a few. Records left from an
    earlier window (spans that closed after ``disable()``) are dropped."""
    global _on, _offset_ns, _records
    _records = []
    best = None
    for _ in range(5):
        a = _now()
        unix = time.time_ns()
        b = _now()
        if best is None or b - a < best[0]:
            best = (b - a, unix - (a + b) // 2)
    _offset_ns = best[1]
    _on = True


def disable() -> None:
    """Turn recording off; spans open now still record when they close."""
    global _on
    _on = False


def drain() -> list:
    """The records so far, oldest closed first; the list is cleared."""
    global _records
    out, _records = _records, []
    return out


def to_chrome(records, base_ns: int = 0, pid: int = None) -> list:
    """Chrome ``"X"`` events of ``records`` on a trace whose
    ``baseTimeNanoseconds`` is ``base_ns`` (``ts`` and ``dur`` in µs)."""
    pid = os.getpid() if pid is None else pid
    return [{"ph": "X", "cat": CATEGORY, "name": r.name, "pid": pid, "tid": r.tid,
             "ts": (r.start_ns - base_ns) / 1e3, "dur": (r.end_ns - r.start_ns) / 1e3,
             "args": {"id": r.id, "parent": r.parent, "step": r.step, "pthread": r.pthread,
                      **r.attrs}}
            for r in records]


def write_into(path: str, records) -> None:
    """Append ``records`` to the Chrome trace at ``path`` (torch.profiler's
    ``export_chrome_trace`` or ``tensorboard_trace_handler``), on its clock."""
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, list):
        data = {"traceEvents": data}
    data["traceEvents"].extend(to_chrome(records, int(data.get("baseTimeNanoseconds", 0))))
    with open(path, "w") as f:
        json.dump(data, f)
