"""Logging, phase timing, per-read forensic tracing, and stage spans.

The first three are the JAX package's `utils/tracing.py` under the same
environment variables.  Reference analogs
(src/c++/include/common/Debug.hh):
  - ISAAC_THREAD_CERR (:40-62)  -> log(): timestamped stderr lines
  - ISAAC_TRACE_STAT  (:59-62)  -> phase(): wall/cpu clock + RSS from
    /proc/self/statm around every major phase
  - ISAAC_THREAD_CERR_DEV_TRACE_CLUSTER_ID (:160-171) -> read tracing:
    the reference compiles per-cluster tracing in/out; here it is
    runtime-gated by the ISAAC_TPU_TRACE_READS env var (comma-separated
    read names) or set_trace_reads(), and dumps each traced read's
    journey through the device pipeline (seed hits, candidates, scores,
    final placement) from the result arrays.

Stage spans (`span`, `spanned`, `collect`) are the port's own: each adds
its wall seconds to the `timings` dict of the aligner doing the work
(`MatchSelectorStats.json` `stage_seconds`), and, while a torch profiler
is collecting, names its stretch of the trace "isaac:<name>".  This
module imports no torch: the output process imports it too.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import os
import sys
import time

_enabled = os.environ.get("ISAAC_TPU_LOG", "") not in ("", "0")
_trace_names: set[str] | None = None


def enable_logging(on: bool = True) -> None:
    global _enabled
    _enabled = on


def log(msg: str, *, force: bool = False) -> None:
    """Timestamped stderr log line (ISAAC_THREAD_CERR analog)."""
    if _enabled or force:
        ts = time.strftime("%Y-%m-%d %H:%M:%S")
        print(f"{ts}\t[isaac-tpu]\t{msg}", file=sys.stderr, flush=True)


def _rss_mb() -> float:
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / 1e6
    except (OSError, ValueError, IndexError):
        return float("nan")


@contextlib.contextmanager
def phase(name: str):
    """Log wall/cpu time + RSS around a pipeline phase (ISAAC_TRACE_STAT)."""
    t0, c0 = time.time(), time.process_time()
    log(f"{name}: start (rss {_rss_mb():.0f} MB)")
    try:
        yield
    finally:
        log(f"{name}: done in {time.time() - t0:.2f}s wall / "
            f"{time.process_time() - c0:.2f}s cpu (rss {_rss_mb():.0f} MB)")


# -- per-read tracing -------------------------------------------------------

def set_trace_reads(names) -> None:
    """Enable forensic tracing for these read names (None disables)."""
    global _trace_names
    _trace_names = set(names) if names is not None else None


def _active_trace_names() -> set[str]:
    if _trace_names is not None:
        return _trace_names
    env = os.environ.get("ISAAC_TPU_TRACE_READS", "")
    return {n for n in env.split(",") if n}


def trace_batch(names: list[str], res: dict, suffix: str = "") -> None:
    """Dump the pipeline's view of any traced read in this batch.

    `res` is the host-side result dict of the Aligner
    (align/pipeline.py finalize_* keys, optionally suffixed _1/_2).
    """
    targets = _active_trace_names()
    if not targets:
        return
    k = lambda base: base + suffix

    def get(base, i):
        arr = res.get(k(base))
        return None if arr is None else arr[i]

    for i, name in enumerate(names):
        if name not in targets:
            continue
        lines = [f"TRACE read {name!r}{suffix}:"]
        for base in ("aligned", "start", "reverse", "mapq", "mismatches",
                     "edit_distance", "log_prob", "others_sum",
                     "num_candidates", "candidate_overflow", "cigar",
                     "properly_paired", "rescued"):
            v = get(base, i)
            if v is not None:
                lines.append(f"  {base} = {v}")
        cs, cv = res.get(k("cand_start")), res.get(k("cand_valid"))
        if cs is not None and cv is not None:
            cm = res.get(k("cand_mismatches"))
            ci = i
            comp = res.get(k("cand_rows"))
            if comp is not None:
                # compacted candidate block: find this row's slot
                hits = [j for j, r in enumerate(comp) if int(r) == i]
                ci = hits[0] if hits else None
            if ci is not None:
                cands = [
                    f"(start={int(cs[ci, j])}"
                    + (f", mm={int(cm[ci, j])}" if cm is not None else "")
                    + ")"
                    for j in range(cs.shape[1]) if bool(cv[ci, j])]
                lines.append(
                    f"  candidates[{len(cands)}] = {' '.join(cands)}")
        log("\n".join(lines), force=True)


# -- stage spans --------------------------------------------------------------

#: prefix of the program's ranges in a torch.profiler trace (`bench:` is
#: the benchmark's own)
PROFILER_PREFIX = "isaac:"

_collector: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "isaac_span_collector", default=None)


@contextlib.contextmanager
def collect(timings: dict):
    """Spans opened in the block, at any depth of calls, add their
    seconds to `timings` (an aligner's `timings`)."""
    token = _collector.set(timings)
    try:
        yield timings
    finally:
        _collector.reset(token)


def _profiling() -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and torch._C._autograd._profiler_enabled()


class span:
    """`with span("polish.gapped"):` adds the block's wall seconds
    (time.perf_counter, recorded also when the block raises) to the
    current collector under the name; without one it adds nothing.  While
    a torch profiler is collecting, the block is also a range named
    "isaac:<name>" on the host's timeline of the trace, on the clock of
    the device's kernels and copies.  The range is a function-scope
    record (`_RecordFunctionFast`), not a user annotation: the profiler
    draws no copy of it on the device's timeline, whose busy time stays
    that of the kernels and copies alone; a kernel belongs to the range
    that holds its launch (the launch's correlation id).

    Spans go around stages, never around a row or a pair: with the
    profiler off one costs two perf_counter calls, a dict add and a
    check of the profiler's flag."""

    __slots__ = ("name", "t0", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = None
        if _profiling():
            self.rf = sys.modules["torch"]._C._profiler._RecordFunctionFast(
                PROFILER_PREFIX + self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        timings = _collector.get()
        if timings is not None:
            timings[self.name] = timings.get(self.name, 0.0) + dt
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def spanned(name: str):
    """Decorator: every call of the function is a `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap
