"""The port's clipped answers in a benchmark cell against the plain
reference of the default clipping passes (`benchmark/reference/clips.py`).

    python benchmark/clipcheck.py --workload <cell> --seed <n> \\
        [--seconds 40] [--device cuda]

sets up the cell as `benchmark/run.py` does (same genome, library, rows
drawn from the seed), runs its window, and for the kept rows of every
batch the window ran works each end out again with the reference from
its unclipped placement (`clips.unclipped` of the port's start and
CIGAR): POS, CIGAR and NM of every aligned end, and per pair the proper
flag (by the learned template-length model) and TLEN (from the final
placements, as the port's records have it).  Prints one JSON line: rows
and ends checked, disagreements by field with the first few of each, the
ends the reference trimmed, semialigned-clipped and overlap-clipped, and
the aligner's own counters over the window.  A measuring tool beside the
benchmark; `run.py` does not call it.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))
if str(HERE.parent) not in sys.path:
    sys.path.insert(1, str(HERE.parent))

import generator  # noqa: E402
import harness  # noqa: E402
import program  # noqa: E402
import run  # noqa: E402
from entries.library import Library  # noqa: E402
from reference import clips  # noqa: E402

COUNTERS = ("trimmed_ends", "semialigned_clipped", "reclipped",
            "overlap_clipped", "indel_moved", "indel_repaired",
            "sw_pairs", "sw_accepted")


def port_tlen(contig_starts, pos, spans) -> list[int]:
    """TLEN of both ends from the final placements (the records' rule)."""
    c = [clips.contig_of(contig_starts, p) for p in pos]
    if c[0] != c[1]:
        return [0, 0]
    span = max(pos[0] + spans[0], pos[1] + spans[1]) - min(pos)
    return [span, -span] if pos[0] <= pos[1] else [-span, span]


def check(entry, ctx) -> dict:
    lib, al = ctx.library, entry.aligner
    t = al.tls
    tls = {"min": int(t.min), "max": int(t.max),
           "best": (int(t.best0), int(t.best1))}
    starts, stops = list(ctx.genome.offsets), list(ctx.genome.ends)
    size = int(ctx.traffic["batch_pairs"])
    out = {"rows": 0, "ends": 0, "bad": {}, "first": {},
           "reference": {"trimmed": 0, "semialigned": 0, "overlap": 0}}
    l = lib.read_len
    done = set()
    for k, kept in entry.kept:
        if k in done:      # a batch answers alike each time it runs
            continue
        done.add(k)
        for j, r in enumerate(entry.rows[k].tolist()):
            tpl = k * size + r
            ends, port = [], []
            for e, sfx in ((0, "_1"), (1, "_2")):
                aligned = bool(kept["aligned" + sfx][j])
                cig = kept["cigar" + sfx][j]
                st, ops = (clips.unclipped(int(kept["start" + sfx][j]), cig,
                                           l) if aligned else (-1, []))
                ends.append({"aligned": aligned, "start": st,
                             "reverse": bool(kept["reverse" + sfx][j]),
                             "ops": ops, "bases": lib.bases[e, tpl],
                             "quals": lib.quals[e, tpl]})
                port.append((int(kept["start" + sfx][j]), cig or f"{l}M",
                             int(kept["edit_distance" + sfx][j]))
                            if aligned else None)
            ref, pair = clips.clip_pair(ctx.genome.codes, starts, stops,
                                        ends, tls)
            out["rows"] += 1
            found = []
            for e in (0, 1):
                if port[e] is None:
                    continue
                out["ends"] += 1
                want = (ref[e]["pos"], ref[e]["cigar"], ref[e]["nm"])
                for name, a, b in zip(("pos", "cigar", "nm"), port[e], want):
                    if a != b:
                        found.append((name, e + 1, port[e], want))
                for key in out["reference"]:
                    out["reference"][key] += int(ref[e][key])
            if port[0] and port[1]:
                proper = bool(kept["proper"][j])
                if proper != pair["proper"]:
                    found.append(("proper", 0, proper, pair["proper"]))
                spans = [clips.ref_span(clips.parse(p[1], l)) for p in port]
                tlen = port_tlen(starts, [port[0][0], port[1][0]], spans)
                if tlen != pair["tlen"]:
                    found.append(("tlen", 0, tlen, pair["tlen"]))
            for name, e, a, b in found:
                out["bad"][name] = out["bad"].get(name, 0) + 1
                first = out["first"].setdefault(name, [])
                if len(first) < 5:
                    first.append({"template": tpl, "end": e, "port": a,
                                  "reference": b})
    return out


def clip_check(cell: dict, seed: int, seconds: float, device: str = "cuda",
               scale: dict | None = None) -> dict:
    """One run of a library cell and the reference's check of its kept
    rows; `scale` overrides configuration and traffic keys as
    `run.run_cell`'s does (tests on the CPU only)."""
    config = harness.find_config(cell["config"])
    traffic = harness.find_traffic(cell["traffic"])
    for key, val in (scale or {}).items():
        block, name = key.split(".", 1)
        target = config if block == "config" else traffic
        *path, leaf = name.split(".")
        for p in path:
            target = target[p]
        target[leaf] = val
    with tempfile.TemporaryDirectory(prefix="isaac_clipcheck_") as tmp:
        ctx = run.Context(config=config, traffic=traffic, seed=seed,
                          device=device, workdir=Path(tmp))
        ctx.genome = generator.make_genome(config["genome"])
        ctx.index_path, _ = program.ensure_index(
            config, ctx.genome, harness.cache_dirs()["index"])
        ctx.library = generator.make_library(
            ctx.genome, traffic["library"], traffic["pairs"], seed)
        entry = Library(ctx)
        before = {c: getattr(entry.aligner, c, None) for c in COUNTERS}
        entry.choose_rows(np.random.default_rng([seed, 1]),
                          int(traffic["check"]["pairs_per_unit"]))
        win = entry.window(seconds)
        counters = {c: (getattr(entry.aligner, c) - before[c]
                        if before[c] is not None else None)
                    for c in COUNTERS}
        out = check(entry, ctx)
    out.update(workload=cell["name"], seed=seed, units=win["units"],
               reads=win["reads"], counters=counters)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = harness.find_cell(harness.benchmark_spec(), args.workload)
    harness.set_cache_env()
    out = clip_check(cell, args.seed, args.seconds, args.device)
    out["card"] = harness.power_limit()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
