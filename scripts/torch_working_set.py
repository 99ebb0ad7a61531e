#!/usr/bin/env python3
"""Measure the device memory a batch holds beside the index planes on one
GPU, and fit the model of `workflow.align.batch_working_set`.

For each read length of --lengths, single-end and paired, against one
index, against two contig groups both resident, and against one index
with the seed stage's neighbor pass on (--neighborhood-size-threshold
100), and for each batch of --rows read rows (reads, or twice the
pairs), runs --batches batches of
simulated reads through the aligner that `AlignWorkflow` runs on the card
(`Aligner` / `PairedAligner`, or `MultiIndexAligner` /
`MultiIndexPairedAligner` over the groups) and records the peak it needs
beside the planes.  A first batch, dispatched to every group, is the
shape's first sight (eager); the measured batches then capture the device
program as a CUDA graph and replay it (`graphs.py`), as a job's do.  A
replay's temporaries live in the graph's memory pool, which stays held
while the polish and the rescue allocate beside it, and which
torch.cuda.max_memory_allocated counts only at the capture.  So the need
taken is the larger of the capturing batch's allocated peak and the
replaying batches' allocated peak plus the bytes the pool holds free for
the replays (`memory_snapshot`'s segments outside the default pool), each
less what was allocated before (the planes).  Each run also gives those
readings apart, the reserved peak (torch.cuda.max_memory_reserved less
the planes' segments, the caching allocator's slack included), the
model's `batch_working_set` and whether the need lies under it.  It also
sums the bytes of one dispatch's outputs: what stays alive while a
resident batch's other groups run.  Then it fits, per template (a read,
or a pair: a batch's size),

    bytes = F + templates * (a + b * read_len
                             + (groups - 1) * (p + q * read_len)
                             + neighbors * (c + d * read_len))

as an upper envelope: (a, b, p, q, c, d) by least squares to the bytes a
template of the largest batches (where the per-template terms dominate),
`a` raised until none of them lies above, then F the largest excess of any
run over the per-template terms (the parts that do not grow with the
batch, such as the rescue's capped chunks).  It prints one line per run,
the constants, and last one JSON object with every run, the fit and the
card's name and power limit.

    python3 scripts/torch_working_set.py [--lengths 100,150,251]
        [--rows 8192,65536] [--batches 2] [--seed 0]

Needs torch, numpy, nvcc and one GPU.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from chip_smoke import card_line  # noqa: E402
from isaac_aligner_tpu_torch import synthetic  # noqa: E402
from isaac_aligner_tpu_torch.align.pipeline import (  # noqa: E402
    AlignConfig, default_seed_offsets)
from isaac_aligner_tpu_torch.aligner import Aligner, PairedAligner  # noqa: E402
from isaac_aligner_tpu_torch.index.build import build_index  # noqa: E402
from isaac_aligner_tpu_torch.index.groups import (  # noqa: E402
    split_genome_groups, subset_genome)
from isaac_aligner_tpu_torch.io.fastq import ReadBatch  # noqa: E402
from isaac_aligner_tpu_torch.parallel.multi_index import (  # noqa: E402
    MultiIndexAligner, MultiIndexPairedAligner)
from isaac_aligner_tpu_torch.workflow.align import (  # noqa: E402
    batch_working_set)

GROUP_LIMIT = 2_400_000     # the 4.6 Mbp genome as two groups of 4 contigs
NB_THRESHOLD = 100          # --neighborhood-size-threshold of the neighbor runs


def batch(bases: np.ndarray, prefix: str) -> ReadBatch:
    n, length = bases.shape
    return ReadBatch(names=[f"{prefix}{i}" for i in range(n)], bases=bases,
                     quals=np.full((n, length), 30, np.uint8),
                     lengths=np.full(n, length, np.int32))


def make_aligner(indexes, paired: bool, read_len: int, neighbors: bool):
    cfg = AlignConfig(seed_offsets=default_seed_offsets(read_len, 32),
                      neighborhood_size_threshold=NB_THRESHOLD * neighbors)
    if len(indexes) > 1:
        cls = MultiIndexPairedAligner if paired else MultiIndexAligner
        return cls.create(indexes, read_len=read_len, cfg=cfg, device="cuda")
    cls = PairedAligner if paired else Aligner
    return cls.create(indexes[0], read_len=read_len, cfg=cfg, device="cuda")


def first_sight(al, inputs) -> int:
    """Dispatch a batch to every group, each group's first sight of its
    shape (eager); the bytes of the device tensors one group's dispatch
    returns."""
    if hasattr(al, "aligners"):
        out = al._dispatch_all(*inputs)[0][0]
    else:
        out = al._dispatch(*inputs)[0]
    torch.cuda.synchronize()
    return sum(v.numel() * v.element_size() for v in out.values()
               if isinstance(v, torch.Tensor))


def graph_pool_free() -> int:
    """Bytes that the CUDA graphs' private pools hold and no live tensor
    takes: the space of their replays' temporaries."""
    return sum(s["total_size"] - s["allocated_size"]
               for s in torch.cuda.memory_snapshot()
               if tuple(s["segment_pool_id"]) != (0, 0))


def measure(rng, genome, indexes, paired: bool, read_len: int, rows: int,
            n_batches: int, neighbors: bool) -> dict:
    """The peak bytes needed beyond the planes over `n_batches` batches
    of `rows` read rows (module docstring)."""
    al = make_aligner(indexes, paired, read_len, neighbors)
    if paired:
        # inserts scale with the read: N(300, 50) in [150, 500] at 100 bp
        sp = synthetic.make_pairs(
            rng, genome.codes, n_batches * rows // 2, read_len=read_len,
            insert=(3.0 * read_len, read_len / 2),
            insert_range=(read_len + read_len // 2, 5 * read_len))
        n = rows // 2
        batches = [(batch(sp.bases1[i:i + n], "t"),
                    batch(sp.bases2[i:i + n], "t"))
                   for i in range(0, n_batches * n, n)]
        al.learn_tls(batches[:1])
    else:
        sim = synthetic.make_reads(rng, genome.codes, n_batches * rows,
                                   read_len=read_len)
        batches = [(batch(sim.bases[i:i + rows], "r"),)
                   for i in range(0, n_batches * rows, rows)]
    pending = first_sight(al, batches[0])
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    base_reserved = torch.cuda.memory_reserved()
    base_pool = graph_pool_free()
    torch.cuda.reset_peak_memory_stats()
    stream = batches if paired else [b[0] for b in batches]
    results = al.align_results_many(stream)
    next(results)                   # the second sight: captured
    torch.cuda.synchronize()
    capture = torch.cuda.max_memory_allocated() - base
    reserved = torch.cuda.max_memory_reserved() - base_reserved
    torch.cuda.reset_peak_memory_stats()
    for _ in results:               # replays
        pass
    torch.cuda.synchronize()
    allocated = torch.cuda.max_memory_allocated() - base
    reserved = max(reserved,
                   torch.cuda.max_memory_reserved() - base_reserved)
    pool = graph_pool_free() - base_pool
    del al, results
    gc.collect()
    torch.cuda.empty_cache()
    r = {"paired": paired, "read_len": read_len, "rows": rows,
         "groups": len(indexes), "neighbors": neighbors,
         "bytes": max(capture, allocated + pool), "capture": capture,
         "allocated": allocated, "graph_pool_free": pool,
         "reserved": reserved, "dispatch_bytes": pending}
    r["model"] = batch_working_set(templates(r), read_len, len(indexes),
                                   neighbors)
    return r


def templates(r: dict) -> int:
    return r["rows"] // 2 if r["paired"] else r["rows"]


def per_template_terms(r: dict) -> list[float]:
    g = r["groups"] - 1
    n = float(r["neighbors"])
    return [1.0, r["read_len"], g, g * r["read_len"], n, n * r["read_len"]]


def fit(runs: list[dict]) -> dict:
    """The upper envelope of the module docstring.  Terms that come out
    negative are dropped and the rest refitted: a byte count does not
    shrink with the read or the groups."""
    largest = {}
    for r in runs:
        largest[r["paired"]] = max(largest.get(r["paired"], 0), templates(r))
    top = [r for r in runs if templates(r) == largest[r["paired"]]]
    a = np.array([per_template_terms(r) for r in top])
    y = np.array([r["bytes"] / templates(r) for r in top])
    keep = np.ones(a.shape[1], bool)
    coef = np.zeros(a.shape[1])
    while True:
        coef[:] = 0.0
        coef[keep] = np.linalg.lstsq(a[:, keep], y, rcond=None)[0]
        neg = keep & (coef < 0)
        if not neg.any():
            break
        keep &= ~neg
    coef[0] += max(0.0, float((y - a @ coef).max()))
    fixed = max(0.0, max(r["bytes"] - templates(r)
                         * float(np.dot(per_template_terms(r), coef))
                         for r in runs))
    return {"F": fixed, **dict(zip("abpqcd", (float(c) for c in coef)))}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lengths", default="100,150,251")
    ap.add_argument("--rows", default="8192,65536")
    ap.add_argument("--batches", type=int, default=2,
                    help="at least 2: a capture, then replays")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no GPU")
    card = card_line()
    rng = np.random.default_rng(args.seed)
    genome = synthetic.make_genome(rng, n_contigs=8)
    one = [build_index(genome, seed_len=32)]
    grouped = [build_index(subset_genome(genome, names), seed_len=32)
               for names in split_genome_groups(genome.contigs, GROUP_LIMIT)]
    # (indexes, neighbor pass)
    layouts = ((one, False), (grouped, False), (one, True))
    runs = []
    for read_len in (int(x) for x in args.lengths.split(",")):
        for paired in (False, True):
            for indexes, neighbors in layouts:
                for rows in (int(x) for x in args.rows.split(",")):
                    r = measure(rng, genome, indexes, paired, read_len, rows,
                                args.batches, neighbors)
                    runs.append(r)
                    print(f"{'paired' if paired else 'single'} L={read_len} "
                          f"groups={len(indexes)} neighbors={neighbors} "
                          f"rows={rows}: {r['bytes']} B "
                          f"({r['bytes'] / rows:.1f} B a row; capture "
                          f"{r['capture']}, replays' allocated "
                          f"{r['allocated']} + graph pool free "
                          f"{r['graph_pool_free']}; reserved "
                          f"{r['reserved']}), model {r['model']} B "
                          f"({'under' if r['bytes'] <= r['model'] else 'OVER'}"
                          f"), one dispatch's outputs {r['dispatch_bytes']} "
                          f"B ({r['dispatch_bytes'] / rows:.1f} B a row) "
                          f"[{card}]", flush=True)
    model = fit(runs)
    print(f"fit: F {model['F']:.0f} B; a template a {model['a']:.1f} + b "
          f"{model['b']:.3f} x read_len B, each further group p "
          f"{model['p']:.1f} + q {model['q']:.4f} x read_len B, the neighbor "
          f"pass c {model['c']:.1f} + d {model['d']:.3f} x read_len B",
          flush=True)
    print(json.dumps({"card": card, "runs": runs, "fit": model}))


if __name__ == "__main__":
    main()
