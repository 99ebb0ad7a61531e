"""Readings of the numbers that decide `correct`, for setting their
limits: runs of a cell, or of any configuration under any traffic mix, on
the card as the benchmark runs them, sound or with a fault or the control
planted in the program (`program.planted`); one JSON line of readings a
seed and fault.

    python benchmark/control.py --workload ecoli_mg1655_noclip.pe150.lib \
        --seeds 1,2,3 --seconds 8 --faults none,control,gapped_polish_off
    python benchmark/control.py --config ecoli_mg1655_noclip \
        --traffic pe150_wf --seeds 4 --seconds 40 \
        --set config.options.clip_semialigned=true

`control` plants the cell's control, named by `_control` in its
`limits/<cell>.json`: `bf16_log_probs`, the per-base log-probabilities
the card sums rounded to bfloat16, the precision below the
configurations' float32.  The faults break a guarantee the configuration
states: `second_pass_off` (the seed offsets of the program's second seed
pass left unsearched), `gapped_polish_off` (no gapped polish: reads with
indels stay ungapped), `merge_left_out` (every contig group but the first
left out of the merge).  `--set key=value` (a JSON value) runs another
deployment or mix, for witnesses.  The benchmark's own runs never plant
anything.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))
if str(HERE.parent) not in sys.path:
    sys.path.insert(1, str(HERE.parent))


def main(argv=None) -> int:
    import harness
    import run
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--config")
    ap.add_argument("--traffic")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--faults", default="none")
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    harness.set_cache_env()
    if args.workload:
        cell = harness.find_cell(harness.benchmark_spec(), args.workload)
    else:
        cell = {"name": f"{args.config}.{args.traffic}", "config": args.config,
                "traffic": args.traffic, "chips": 1}
    scale = {}
    for item in args.set:
        key, val = item.split("=", 1)
        scale[key] = json.loads(val)
    for seed in (int(s) for s in args.seeds.split(",")):
        for fault in args.faults.split(","):
            if fault == "control":
                fault = run.limits_for(cell["name"])["_control"]
            fault = None if fault == "none" else fault
            t0 = time.perf_counter()
            out = run.run_cell(cell, seed, args.seconds, False,
                               device=args.device, fault=fault,
                               scale=scale or None)
            rec = out["record"]
            print(json.dumps({
                "cell": cell["name"], "seed": seed, "fault": fault,
                "units": out["window"]["units"],
                "reads": out["window"]["reads"],
                "window_s": rec["window_s"], "setup_s": rec["setup_s"],
                "check_s": rec["check_s"],
                "wall_s": time.perf_counter() - t0,
                "readings": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
