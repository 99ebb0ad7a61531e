"""Device time and device idle time by the program's own spans, from a
torch.profiler trace, and a traced run of one cell that prints them.

The program names its stages in the trace as host ranges "isaac:<name>"
(`isaac_aligner_tpu_torch/utils/tracing.span`).  A kernel, copy or set on
the card belongs to the innermost such range that holds the host call
that launched it (the launch and the device event share a correlation
id); launches are asynchronous, so overlap on the device's timeline says
nothing of who launched what.  An idle stretch of the card belongs to
the innermost range open on the host while it lasts.

    python benchmark/spantrace.py --workload <cell> --seed <n> \\
        --seconds <s>

runs the cell as `run.py --trace 1` does and prints one JSON line: the
window's rate and stage seconds, the per-layer metrics, and the traced
round's `span_device_s`, `idle_by_span` and the share of kernel time the
spans hold.  It is a measuring tool beside the benchmark: `run.py` and
its result line do not call it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

PREFIX = "isaac:"
#: names of the ranges that a program or the benchmark draws with
#: torch.profiler.record_function, where the event cannot say so itself
ANNOTATION_PREFIXES = ("bench:", PREFIX)
OUTSIDE = "outside"


def _annotation(e) -> bool:
    """A range drawn on the device's timeline by record_function, which
    is no device work."""
    flag = getattr(e, "is_user_annotation", None)
    if flag is not None:
        return bool(flag())
    return e.name().startswith(ANNOTATION_PREFIXES)


def _innermost(spans: np.ndarray, names: list[str], t: int,
               mask=None) -> str:
    """Name of the shortest span of `spans` ([n, 2] ns) holding `t`."""
    inside = (spans[:, 0] <= t) & (t < spans[:, 1])
    if mask is not None:
        inside &= mask
    if not inside.any():
        return OUTSIDE
    dur = np.where(inside, spans[:, 1] - spans[:, 0], np.iinfo(np.int64).max)
    return names[int(np.argmin(dur))]


def reduce_spans(events, edges) -> dict:
    """From kineto events and the window's ends `edges` (ns, the events'
    clock): `span_device_s` {span: device seconds of the kernels, copies
    and sets it launched}, `idle_by_span` {innermost span open on the
    host, or "outside": seconds of the window the card was idle}, and
    `kernel_s` / `kernel_s_in_spans` (kernels alone, copies and sets
    aside)."""
    spans, names, threads = [], [], []
    launches: dict[int, tuple[int, int]] = {}
    dev = []
    for e in events:
        name = e.name()
        start = int(e.start_ns())
        end = start + int(e.duration_ns())
        if e.device_type().name == "CUDA":
            if not _annotation(e):
                dev.append((start, end, int(e.correlation_id()), name))
        elif name.startswith(PREFIX):
            spans.append((start, end))
            names.append(name[len(PREFIX):])
            threads.append(int(e.start_thread_id()))
        elif name.startswith("cu"):        # a CUDA runtime or driver call
            launches[int(e.correlation_id())] = (start, int(e.start_thread_id()))
    sp = np.array(spans, np.int64).reshape(-1, 2)
    tid = np.array(threads, np.int64)

    span_device_s: dict[str, float] = {}
    kernel_s = kernel_in = 0.0
    for start, end, corr, name in dev:
        launch = launches.get(corr)
        owner = OUTSIDE if launch is None else _innermost(
            sp, names, launch[0], tid == launch[1])
        secs = (end - start) * 1e-9
        span_device_s[owner] = span_device_s.get(owner, 0.0) + secs
        if not name.startswith(("Memcpy", "Memset")):
            kernel_s += secs
            kernel_in += secs if owner != OUTSIDE else 0.0
    span_device_s.pop(OUTSIDE, None)

    # idle stretches of the window: its complement of the device's union
    e0, e1 = int(edges[0]), int(edges[1])
    busy = sorted((max(s, e0), min(e, e1)) for s, e, _c, _n in dev
                  if e > e0 and s < e1)
    idle, t = [], e0
    for s, e in busy:
        if s > t:
            idle.append((t, s))
        t = max(t, e)
    if t < e1:
        idle.append((t, e1))
    cuts = np.unique(np.concatenate([
        np.array(idle, np.int64).reshape(-1), sp.reshape(-1)]))
    cuts = cuts[(cuts >= e0) & (cuts <= e1)]
    iv = np.array(idle, np.int64).reshape(-1, 2)
    idle_by_span: dict[str, float] = {}
    for a, b in zip(cuts[:-1].tolist(), cuts[1:].tolist()):
        mid = (a + b) // 2
        k = int(np.searchsorted(iv[:, 0], mid, side="right")) - 1
        if k < 0 or mid >= iv[k, 1]:
            continue                       # the card was busy
        owner = _innermost(sp, names, mid)
        idle_by_span[owner] = idle_by_span.get(owner, 0.0) + (b - a) * 1e-9
    return {"span_device_s": span_device_s, "idle_by_span": idle_by_span,
            "kernel_s": kernel_s, "kernel_s_in_spans": kernel_in}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    import devtrace
    import harness
    import run
    spec = harness.benchmark_spec()
    cell = harness.find_cell(spec, args.workload)
    harness.set_cache_env()
    reduce_events = devtrace.reduce_events

    def with_spans(events, wall, *a, edges=None, **k):
        events = list(events)
        out = reduce_events(events, wall, *a, edges=edges, **k)
        out.update(reduce_spans(events, edges))
        return out

    devtrace.reduce_events = with_spans
    try:
        out = run.run_cell(cell, args.seed, args.seconds, True)
    finally:
        devtrace.reduce_events = reduce_events
    rec, win = out["record"], out["window"]
    correct, checks = run.judge(out["checks"], run.limits_for(args.workload))
    prof = rec["profile"]
    traced_reads = 2 * int(out["traffic"]["pairs"])
    per_mread = 1e6 / traced_reads
    line = {
        "workload": args.workload, "seed": args.seed,
        "card": harness.power_limit(), "correct": correct,
        "align_reads_per_s": win["reads"] / win["elapsed"],
        "setup_s": rec["setup_s"],
        "metrics": {k: v["value"] for k, v in run.read_metrics(
            harness.cell_metrics(spec, args.workload, "per_layer"),
            rec).items()},
        "stage_s_per_mread": {k: v * 1e6 / win["reads"]
                              for k, v in rec["stage_seconds"].items()},
        "traced": {
            "reads": traced_reads, "wall_s": rec["traced"]["wall"],
            "window_s": prof["window_s"], "busy_s": prof["busy_s"],
            "device_s_per_mread": {k: v * per_mread for k, v in
                                   prof["span_device_s"].items()},
            "idle_s": prof["idle_by_span"],
            "kernel_s": prof["kernel_s"],
            "kernel_share_in_spans": (prof["kernel_s_in_spans"]
                                      / prof["kernel_s"]
                                      if prof["kernel_s"] else None)},
        "checks": checks,
    }
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
