"""Host-side input pipeline: background prefetch of batch windows.

The port's own copy of gpt2_vision_language_tpu/data/pipeline.py (host-only).
It stands in for the reference's torch DataLoader worker pool
(gpt2_linear/train.py:90-93): a daemon thread prepares the NEXT
grad-accumulation window (dataset reads, tokenization, stacking) while the
device executes the current step, and optionally stages it onto the device
(one pinned host->device copy) so the transfer also overlaps compute. Depth-2
queue = classic double buffering.

Its counter, always on: ``wait_s``, the seconds spent in ``next()``. Its
spans (``obs/spans.py``):
``data.wait`` around ``next()``, ``data.produce`` and ``data.stage`` on the
producer thread.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Optional

from ..obs.spans import span


class HostPrefetcher:
    """Wraps `produce() -> batch` with a background thread + bounded queue."""

    def __init__(
        self,
        produce: Callable[[], object],
        *,
        depth: int = 2,
        stage: Optional[Callable[[object], object]] = None,
    ):
        self._produce = produce
        self._stage = stage
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self.wait_s = 0.0
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                with span("data.produce"):
                    batch = self._produce()
                if self._stage is not None:
                    with span("data.stage"):
                        batch = self._stage(batch)
                while not self._stop.is_set():
                    try:
                        self._q.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # noqa: BLE001 — surfaced on next()
            self._exc = e

    def next(self):
        t0 = time.perf_counter()
        try:
            with span("data.wait"):
                while True:
                    # deliver already-produced batches before surfacing a late error
                    try:
                        return self._q.get_nowait()
                    except queue.Empty:
                        pass
                    if self._exc is not None:
                        raise self._exc
                    try:
                        return self._q.get(timeout=0.5)
                    except queue.Empty:
                        if not self._thread.is_alive() and self._exc is None:
                            raise RuntimeError("prefetch thread died without error")
        finally:
            self.wait_s += time.perf_counter() - t0

    def close(self) -> None:
        self._stop.set()
        # drain so the producer unblocks
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
