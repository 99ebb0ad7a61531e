"""Benchmark of isaac_aligner_tpu_torch (the PyTorch and CUDA port) on the
card: one run of one cell.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (`BENCHMARK.json` `workloads`) names a configuration
(`benchmark/configs/<name>.json`: a reference genome at workflow
settings, with the `options` the program runs at) and a traffic mix
(`benchmark/traffic/<name>.json`: the entry that serves it and the read
library it draws, `benchmark/libraries/<name>.json`).  A run makes the
genome from the configuration and the library from `--seed`, loads or
builds the index, warms up, measures for `--seconds`, frees the program,
judges what the timed path produced against the plain reference
(`benchmark/reference/`), and prints one JSON line last on standard
output.  With `--trace 1` the line carries the cell's per-layer metrics
(`benchmark/metrics/<name>.py`), read from the window's counters and a
torch.profiler trace of one more job or round of batches.

Nothing this process loads may be JAX or the JAX package: the run fails
if it finds one once the window has closed.  The workflow's output
process re-imports this file under `__mp_main__`, so the module does its
work only under `__main__`.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))
if str(HERE.parent) not in sys.path:
    sys.path.insert(1, str(HERE.parent))

import harness  # noqa: E402

ENTRIES = {"workflow": ("entries.workflow", "Workflow"),
           "library": ("entries.library", "Library")}


@dataclasses.dataclass
class Context:
    config: dict
    traffic: dict
    seed: int
    device: str
    workdir: Path
    genome: object = None
    library: object = None
    index_path: Path | None = None
    index_build_s: float = 0.0


def limits_for(cell: str, base: Path = HERE) -> dict:
    return harness.load_json(base / "limits" / f"{cell}.json")


def judge(checks: dict, limits: dict) -> tuple[bool, dict]:
    """({name: [number, limit]}, every number within its limit)."""
    out = {k: [v, limits.get(k, 0)] for k, v in checks.items()
           if not k.startswith("_")}
    return all(v <= lim for v, lim in out.values()), out


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", fault: str | None = None,
             scale: dict | None = None,
             workdir: Path | None = None) -> dict:
    """One run of `cell`: set-up, window, optional trace, release, check.
    `fault` plants a fault or the control in the program (tests and the
    control's readings only); `scale` overrides configuration and traffic
    keys (tests on the CPU only).  Returns the pieces of the result line."""
    import numpy as np

    import generator
    import program
    config = harness.find_config(cell["config"])
    traffic = harness.find_traffic(cell["traffic"])
    for key, val in (scale or {}).items():
        block, name = key.split(".", 1)
        target = config if block == "config" else traffic
        *path, leaf = name.split(".")
        for p in path:
            target = target[p]
        target[leaf] = val
    with tempfile.TemporaryDirectory(prefix="isaac_bench_",
                                     dir=workdir) as tmp:
        ctx = Context(config=config, traffic=traffic, seed=seed,
                      device=device, workdir=Path(tmp))
        with program.planted(fault):
            t0 = time.perf_counter()
            ctx.genome = generator.make_genome(config["genome"])
            ctx.index_path, ctx.index_build_s = program.ensure_index(
                config, ctx.genome, harness.cache_dirs()["index"])
            ctx.library = generator.make_library(
                ctx.genome, traffic["library"], traffic["pairs"], seed)
            mod_name, cls = ENTRIES[traffic["entry"]]
            entry = getattr(importlib.import_module(mod_name), cls)(ctx)
            rng = np.random.default_rng([seed, 1])
            if hasattr(entry, "choose_rows"):
                entry.choose_rows(rng, int(traffic["check"]["pairs_per_unit"]))
            setup_s = time.perf_counter() - t0
            if device != "cpu":
                import torch
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            win = entry.window(seconds)
            record = dict(win["record"], window_s=win["elapsed"],
                          setup_s=setup_s,
                          index_build_s=ctx.index_build_s)
            peak = 0
            if device != "cpu":
                import torch
                peak = int(torch.cuda.max_memory_allocated())
                record["device_peak_bytes"] = peak
                record["card"] = torch.cuda.get_device_name(0)
            if trace:
                import devtrace
                launches: list = []
                prof: dict = {}
                with program.instrumented(launches), devtrace.profiled(prof):
                    record["traced"] = entry.traced()
                record["profile"] = prof
                record["sw_launches"] = launches
        entry.release()
        gc.collect()
        if device != "cpu":
            import torch
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        checks = entry.check(rng, int(traffic["check"]["pairs_per_unit"]))
        record["check_s"] = time.perf_counter() - t1
    return {"window": win, "record": record, "checks": checks,
            "peak": peak, "config": config, "traffic": traffic}


def read_metrics(metrics: list[dict], record: dict) -> dict:
    out = {}
    for m in metrics:
        v = harness.metric_value(harness.metric_reader(m["name"])(record))
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = harness.benchmark_spec()
    cell = harness.find_cell(spec, args.workload)
    harness.set_cache_env()
    import torch
    try:
        device = harness.card_record(torch, int(cell["chips"]))
    except RuntimeError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    card = harness.power_limit()
    print(f"benchmark: {args.workload} seed {args.seed} on {card or device['kind']}",
          file=sys.stderr, flush=True)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    bad = harness.forbidden_loaded()
    if bad:
        print(f"benchmark: loaded {', '.join(bad)} (JAX or the JAX package); "
              f"no result", file=sys.stderr)
        return 3
    rec = out["record"]
    print(f"benchmark: index {'built in %.3f s' % rec['index_build_s'] if rec['index_build_s'] else 'loaded'}, "
          f"set-up {rec['setup_s']:.3f} s, window {rec['window_s']:.3f} s, "
          f"{out['window']['units']} units, {out['window']['reads']} reads, "
          f"check {rec['check_s']:.3f} s",
          file=sys.stderr, flush=True)
    if "job_seconds" in rec:
        print("benchmark: jobs " + ", ".join(
            f"{s:.3f}" for s in rec["job_seconds"]) + " s; stages "
            + ", ".join(f"{k} {v:.2f}" for k, v in rec["stage_seconds"].items())
            + f", build {rec['build_seconds']:.2f} s", file=sys.stderr,
            flush=True)
    correct, checks = judge(out["checks"], limits_for(args.workload))
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = read_metrics(harness.cell_metrics(spec, args.workload, kind),
                           rec)
    device["memory_peak_bytes"] = out["peak"]
    breakdown = None
    if args.trace:
        prof = rec["profile"]
        device["busy_s"] = prof["busy_s"]
        device["window_s"] = prof["window_s"]
        breakdown = {"device_ops": prof["device_ops"],
                     "idle_gaps": prof["idle_gaps"]}
    for name, (value, limit) in checks.items():
        print(f"check {name}: {value} (limit {limit})", file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(correct, out["window"]["units"],
                              out["checks"].get("_bad_units", 0), metrics,
                              device, checks, breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
