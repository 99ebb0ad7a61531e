"""Reduction of a torch.profiler trace to the numbers the per-layer
metrics read: device busy time (the union of every kernel, copy and set
on the card), the window's length, summed time per device operation, the
banded_sw kernel's time, and the longest idle gaps of the card named by
the innermost span the benchmark opened around the host's work then.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np


@contextlib.contextmanager
def profiled(out: dict):
    """Profile the block (CPU and CUDA activities); on exit, fill `out`
    with the reduced trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0, ns0 = time.perf_counter(), time.time_ns()
        yield
        torch.cuda.synchronize()
        wall, ns1 = time.perf_counter() - t0, time.time_ns()
    out.update(reduce_events(prof.profiler.kineto_results.events(), wall,
                             edges=(ns0, ns1)))


def _union(intervals: np.ndarray) -> tuple[float, np.ndarray]:
    """(covered nanoseconds, merged [k, 2] intervals) of [n, 2] ones."""
    if intervals.size == 0:
        return 0.0, intervals.reshape(0, 2)
    iv = intervals[np.argsort(intervals[:, 0])]
    merged = [list(iv[0])]
    for s, e in iv[1:].tolist():
        if s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    m = np.array(merged, np.int64)
    return float((m[:, 1] - m[:, 0]).sum()), m


def reduce_events(events, wall: float, top: int = 10,
                  span_prefix: str = "bench:", edges=None) -> dict:
    """The reduced trace of kineto events over a window of `wall`
    seconds (host clock) whose ends, in the events' clock (ns), are
    `edges`: the idle time before the first and after the last device
    event counts among the gaps.  Host spans are the events named with
    `span_prefix`; the profiler also draws them on the device's timeline
    as annotations, which are no device work and are left out.  A gap is
    named by the innermost span open at its middle."""
    dev, ops, spans = [], {}, []
    for e in events:
        start, dur = int(e.start_ns()), int(e.duration_ns())
        if e.name().startswith(span_prefix):
            if e.device_type().name != "CUDA":    # the span's host side
                spans.append((start, start + dur,
                              e.name()[len(span_prefix):]))
        elif e.device_type().name == "CUDA":
            dev.append((start, start + dur))
            ops[e.name()] = ops.get(e.name(), 0.0) + dur * 1e-9
    busy_ns, merged = _union(np.array(dev, np.int64).reshape(-1, 2))
    gaps = []
    if len(merged):
        starts, ends = merged[1:, 0], merged[:-1, 1]
        if edges is not None:
            starts = np.concatenate([[merged[0, 0]], starts, [edges[1]]])
            ends = np.concatenate([[edges[0]], ends, [merged[-1, 1]]])
        order = np.argsort(starts - ends)[::-1][:top]
        for k in order.tolist():
            g0, g1 = int(ends[k]), int(starts[k])
            if g1 <= g0:
                continue
            mid = (g0 + g1) // 2
            inner = [s for s in spans if s[0] <= mid < s[1]]
            name = min(inner, key=lambda s: s[1] - s[0])[2] if inner \
                else "host outside the benchmark's spans"
            gaps.append([name, (g1 - g0) * 1e-9])
    by_time = sorted(ops.items(), key=lambda kv: kv[1], reverse=True)
    return {"busy_s": busy_ns * 1e-9, "window_s": wall,
            "device_ops": [[k, v] for k, v in by_time[:top]],
            "idle_gaps": gaps, "op_seconds": ops}
