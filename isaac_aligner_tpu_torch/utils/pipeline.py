"""Host-side pipeline threading: prefetch + ordered background stages.

The port's own copy of `isaac_aligner_tpu/utils/pipeline.py`, unchanged.

Reference analog: the reference overlaps its host stages with thread
slots — SelectMatchesTransition.cpp:295-357 (load/compute/flush) and
Build.cpp:793-903 (bin slots).  Here the same overlap is built from two
small primitives; the heavy numpy/zlib/file work all releases the GIL,
so plain threads overlap real work even on a 2-core host:

  * prefetch_iter(it): a daemon thread pumps `it` into a bounded queue,
    so input parsing (FASTQ record blocks, BCL tiles) overlaps with
    alignment of the previous batch.
  * OrderedStage(fn): a 1-worker executor + bounded in-flight window that
    applies `fn` to items strictly in submission order, so record
    conversion + bin writes (or bin BAM serialization) overlap with the
    producer while keeping byte-deterministic output order.
"""

from __future__ import annotations

import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from queue import Queue

_SENTINEL = object()


def prefetch_iter(it, depth: int = 2):
    """Iterate `it` on a background thread, `depth` items ahead.

    Exceptions raised by the source re-raise at the consuming site (the
    workflow's input-validation errors must still surface from run()).
    """
    q: Queue = Queue(maxsize=max(1, depth))

    def pump() -> None:
        try:
            for x in it:
                q.put(x)
            q.put(_SENTINEL)
        except BaseException as e:  # noqa: BLE001 — re-raised in consumer
            q.put(e)

    t = threading.Thread(target=pump, daemon=True,
                         name="isaac-prefetch")
    t.start()
    while True:
        x = q.get()
        if x is _SENTINEL:
            return
        if isinstance(x, BaseException):
            raise x
        yield x


class OrderedStage:
    """Run fn(item) on one background thread, at most `window` in flight.

    submit() blocks (backpressure) when the window is full; close()
    drains and re-raises the first worker exception.  One worker thread
    keeps side effects (chunk-file counters, BAM stream appends, stats
    dicts) ordered without locks.
    """

    def __init__(self, fn, window: int = 2, name: str = "isaac-stage"):
        self.fn = fn
        self.window = max(1, window)
        self._ex = ThreadPoolExecutor(max_workers=1,
                                      thread_name_prefix=name)
        self._pending: deque = deque()

    def submit(self, *args) -> None:
        while len(self._pending) >= self.window:
            self._pending.popleft().result()
        self._pending.append(self._ex.submit(self.fn, *args))

    def close(self) -> None:
        try:
            while self._pending:
                self._pending.popleft().result()
        finally:
            self._ex.shutdown(wait=True)
