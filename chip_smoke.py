#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Drives the port's main paths at the benchmark's E. coli scale: the
single-end library (FASTQ -> Aligner.create(..., device="cuda") ->
align_to_sam_many -> SAM), the workflow users run (FASTQ -> AlignWorkflow
on "cuda" -> sorted, duplicate-marked, gap-realigned BAM with .bai and
.md5), single-end and paired-end, and checks every hand-written kernel on
their path against its plain torch version.  Phases, one line each:

  1. the card (torch.cuda must be available) with its name and power limit;
  2. build the CUDA kernels from the repo's sources (nvcc, sm_90a);
  3. kernel vs plain: banded SW with BWA and ELAND scores at L in
     {1, 4, 5, 100, 101, 150, 251, 400} (896 pairs) and N in {1, 3, 896,
     8,192, 65,537} (L=100), and with every pair a near-match at band
     offset 0 or 15, bit-equal to `banded_sw_torch` on the same CUDA
     tensors and, on 256 pairs, to the numpy oracle; L over the kernel's
     limit raises; times both at 8,192 x 100 (and again at the slice's own
     launch shape after phase 4, the times the kernel line reports); the
     traceback walk `sw_walk` equal to `sw_walk_torch` on every row with
     both scorings at the polish's 1,300 and 2,400 pairs of 150 bp (timed),
     ragged blocks, 896 x 100 and the longest query;
  4. library slice: 4.6 Mbp repeat-rich genome from --seed, 32-mer index,
     4 x 32,768 reads of 100 bp (1% substitutions, half reverse
     complemented, 3% with a 1-8 bp indel) through the aligner on the card;
     checks the aligned fraction, placement, kernel launches and gapped
     CIGARs;
  5. workflow: the same genome's index saved to disk and 524,288 reads of
     100 bp simulated as in phase 4, written as FASTQ, through
     AlignWorkflow on "cuda" at the workflow defaults (batch 32,768, the
     output process on); reads sorted.bam back and checks the record count,
     coordinate order, .bai and .md5, the aligned fraction, placement and
     kernel launches; prints FASTQ->BAM reads/s, the stage split, the Build
     phase's time and counts, and which native host libraries loaded;
  6. card vs CPU: the first 4,096 of phase 5's reads through the workflow
     on both devices give the same (qname, flag, pos, CIGAR, NM) (MAPQ:
     floor flips only), and one 2,048-read batch through the library gives
     the same SAM core fields;
  7. paired workflow: 262,144 pairs of 100 bp on the same genome
     (synthetic.make_pairs: inserts from N(300, 50), both strands, 2% of
     read 2s damaged so that only the shadow rescue places them, 0.5% far
     mates), written as two FASTQs, through AlignWorkflow on "cuda" at
     batch 32,768 and the workflow defaults (TLS learned from 4 batches);
     checks the record count, coordinate order, .bai and .md5, each end's
     aligned fraction and placement, proper pairs, the rescued mates, the
     learned TLS and kernel launches; prints FASTQ->BAM reads/s, the stage
     split, the Build phase and the rescue's device time at the shape the
     run gave it;
  8. paired card vs CPU: the first 4,096 pairs through the workflow on both
     devices give the same TLS and (qname, flag, pos, CIGAR, NM, RNEXT,
     PNEXT, TLEN) (MAPQ: floor flips only), and one 2,048-pair batch
     through PairedAligner.align_to_sam the same;
  9. sort-reference on the card: the same genome as eight contigs, through
     `python -m isaac_aligner_tpu_torch sort-reference --group-limit
     2400000` (two groups of four contigs, annotated on "cuda"); checks the
     manifest, each group's planes and neighbor bits against an in-memory
     build and annotation, contig 0's annotated index against the host
     oracle `find_neighbors`, and 20,000 planted 16/32/64-mers on the card
     against the CPU; prints the build and annotation seconds per group;
 10. grouped single-end workflow: 524,288 reads of 100 bp on the eight
     contigs through AlignWorkflow on "cuda" against the grouped directory,
     both groups resident; checks as phase 5 (placement in global
     coordinates); prints the upload seconds per group and the plane bytes
     beside the card's free memory; holds banded_sw bit-equal to its plain
     version, and times both, at the run's mean pairs per launch; then the
     first 32,768 reads resident and group-major give the same sorted.bam
     bytes, with the card's allocated memory back at its baseline after
     every group's release;
 11. grouped paired workflow: 262,144 pairs on the eight contigs, resident,
     checked as phase 7, banded_sw checked and timed at its mean pairs per
     launch; then the first 4,096 pairs group-major on the card and on the
     CPU give the same TLS and core fields;
 12. 64-mer index: `sort-reference -s 64` of phase 4's genome as one index
     on the card (planes and neighbor bits held against an in-memory build
     and annotation, whose seconds and flagged share it prints); phase 5's
     524,288 reads through AlignWorkflow with -s 64 against it, batch
     32,768: >= 0.95 of the reads with an exact, N-free 64-mer seed window
     aligned and >= 0.95 of the aligned within 8 bp of the truth; the
     working set beside the planes against the model; banded_sw at the
     run's mean pairs per launch; the first 4,096 reads on the card and on
     the CPU give the same core fields;
 13. the seed options on the 32-mer index: phase 7's 262,144 pairs through
     the paired workflow with --neighborhood-size-threshold 100
     --scatter-repeats 1, checked as phase 7, with the working set and
     banded_sw as phase 12; one 32,768-read library batch with the
     threshold, whose seed stage reports neighbor hits (> 0); and card vs
     CPU on 4,096 reads or pairs for each option alone (-s 64 over the
     FASTA, the threshold, --scatter-repeats single-end and paired);
 14. SPMD library: 32,768 of phase 5's reads and 32,768 of phase 7's pairs
     through ShardedAligner and ShardedPairedAligner over meshes of cuda:0
     entries, (data 1, shard 2), (2, 2) and (1, 2) genome-sharded, every
     result field equal to Aligner / PairedAligner on the card (their
     batches replayed as CUDA graphs); prints a batch's wall and dispatch
     ms, sharded and single, and one paired dispatch's kernels and CUDA
     launch calls, eager against replayed; banded_sw checked
     and timed at the sharded runs' mean pairs per launch; then
     mark_duplicates_collective over four cuda:0 entries on phase 7's
     524,288 records equals mark_duplicates_batch with no overflow;
 15. multi-process workflow: scripts/torch_multihost_dryrun.py on phase
     7's pairs, two processes on the card (dist_processes=2, gloo control)
     against one uniform_bins process: sorted.bam, .bai and .md5
     byte-equal, merged stats counts equal; prints each process's stage
     split; banded_sw checked and timed at the two processes' mean pairs
     per launch;
 16. BCL run folder, demultiplexed: phase 7's 262,144 pairs written with
     the port's writers as a run folder with cycles y100,i8,y100 (lane 1:
     four tiles of 32,768 clusters, one .bcl.gz a cycle; lane 2: four
     tiles in the NextSeq BGZF layout with .bci; .clocs positions; 5% of
     clusters failing the filter), four samples with 8-base barcodes at
     Hamming distance >= 3 (1% of clusters one mismatch, 2% random),
     through AlignWorkflow with the sample sheet and --per-tile-tls on
     "cuda" at batch 32,768; checks each sample's record count against an
     independent barcode match, per-end placement, proper pairs, the
     eight tiles' TLS medians, ZX/ZY against the planted positions, BC
     against the index reads, .bai and .md5; prints BCL->BAM reads/s and
     the stage split; banded_sw at the run's shape; card vs CPU on a
     one-tile run folder of 4,096 clusters (TLS and core fields with RG
     and BC);
 17. BAM input: phase 7's coordinate-sorted sorted.bam (524,288 records)
     through AlignWorkflow(bam_input=...) on "cuda": checked as phase 7,
     read 1/read 2 identities kept; prints BAM->BAM reads/s, the stage
     split, and the seconds and peak RSS of the pairedness probe (the
     whole BAM read in a fresh process); banded_sw at the run's shape;
     card vs CPU on phase 8's 4,096-pair BAM;
 18. per-barcode driver: 131,072 pairs from FASTQ plus a barcode FASTQ,
     sample A against phase 5's index (inserts N(300, 50)), B against
     phase 9's two-group directory (N(500, 50)), C "unmapped", 1/8 of
     random barcodes against the run's -r; checks each sample's count,
     A and B placed, their TLS medians, C all unmapped,
     PerBarcodeStats.json, the card's allocated memory back at its
     baseline after each sub-workflow, and banded_sw at the run's shape.

It imports only torch, numpy and the port, and fails if any `jax*` or
`isaac_aligner_tpu` module was loaded by the end.

Every main path's run (and phase 4's) counts both kernels' launches and
fails unless sw_walk launched as often as banded_sw.  After each phase a
line counts the batches' device programs of this process by their path
(`graphs.ProgramGraphs`): graph_replays, graph_captures and
eager_dispatches.  Then one JSON line
of kernel results (launches: the workflows' runs of phases 5, 7, 10, 11,
12, 13, 16, 17 and 18, phase 14's sharded runs and phase 15's two
processes), the card line, and the last line {"ok": true, "device":
{...}}.
Any failed check raises: the exit code is non-zero and no result line is
printed.

    python3 chip_smoke.py [--seed N]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np

# phase 5's output process is spawned and re-imports this file under the
# name __mp_main__: it needs none of these (it imports its own host modules)
if __name__ != "__mp_main__":
    import torch

    from isaac_aligner_tpu_torch import graphs, synthetic
    from isaac_aligner_tpu_torch.align import gapped, pairs, quality
    from isaac_aligner_tpu_torch.align.pipeline import (AlignConfig,
                                                        default_seed_offsets,
                                                        find_seed_hits,
                                                        plane_bytes)
    from isaac_aligner_tpu_torch.aligner import Aligner, PairedAligner
    from isaac_aligner_tpu_torch.index.build import (SeedIndex, build_index,
                                                     unbias_i32_to_u32)
    from isaac_aligner_tpu_torch.index.groups import (load_grouped_indexes,
                                                      split_genome_groups,
                                                      subset_genome)
    from isaac_aligner_tpu_torch.index.neighbors import (annotate_index,
                                                         find_neighbors)
    from isaac_aligner_tpu_torch.index.neighbors_device import \
        find_neighbors_device
    from isaac_aligner_tpu_torch.io import bgzf
    from isaac_aligner_tpu_torch.io.bam import read_bam
    from isaac_aligner_tpu_torch.io.fastq import ReadBatch, read_fastq
    from isaac_aligner_tpu_torch.io.sam import write_sam
    from isaac_aligner_tpu_torch.native import build as native
    from isaac_aligner_tpu_torch.ops import _build, sw
    from isaac_aligner_tpu_torch.workflow import align as wfmod
    from isaac_aligner_tpu_torch.workflow.align import (AlignWorkflow,
                                                        WorkflowOptions)
    from isaac_aligner_tpu_torch.workflow.per_barcode import PerBarcodeDriver

READ_LEN = 100
BATCH = 32_768
N_BATCHES = 4
WF_READS = 524_288          # the JAX benchmark's e2e_se size (bench.py:62)
WF_SUBSET = 4_096
PE_PAIRS = 262_144          # the JAX benchmark's e2e_pe size (bench.py:361)
PE_SUBSET = 4_096
PE_LIB = 2_048
SW_PAIRS = 8_192
N_CONTIGS = 8               # phases 9-11: the genome as eight contigs
GROUP_LIMIT = 2_400_000     # two groups of four 575 kbp contigs
GM_SUBSET = 32_768          # reads run resident and group-major (phase 10)
PLANTED = 20_000            # planted k-mers of the annotation check
NB_THRESHOLD = 100          # phase 13's --neighborhood-size-threshold
SPMD_READS = 32_768         # phase 14: reads (and pairs) a library batch
# phase 14's meshes: (data, shard, genome-sharded)
SPMD_MESHES = ((1, 2, False), (2, 2, False), (1, 2, True))
DEDUP_DEVICES = 4           # phase 14's collective dedup
MH_RECORDS_PER_BIN = 262_144    # phase 15: two uniform bins
BCL_TILES = (1101, 1102, 1103, 1104)    # phase 16: per lane, two lanes
BCL_SUBSET = 4_096          # phase 16: clusters of the card-vs-CPU tile
PB_PAIRS = 131_072          # phase 18: pairs of the per-barcode run
SW_LENGTHS = (1, 4, 5, 100, 101, 150, 251, 400)
SW_BATCHES = (1, 3, 896, 8_192, 65_537)
# sw_walk at the gapped polish's launch sizes on the benchmark's cells
# (~1,300 pairs a call on E. coli, ~2,400 on the GRCh38 cut, 150 bp reads)
WALK_LEN = 150
WALK_PAIRS = (1_300, 2_400)

# The card's peak rates (H100 SXM data sheet, 700 W): 3.35 TB/s of HBM and
# 67 TFLOP/s of f32 outside the tensor cores, i.e. 33.5e12 f32 add lanes/s
# (the data sheet counts an FMA as two).  The CUDA programming guide's
# throughput table (compute capability 9.0) issues compares, min/max and
# 32-bit integer ops at half the f32 add rate, on another pipe than the
# adds; the four schedulers of an SM issue one warp instruction a clock
# each, as many lanes as the add rate.
HBM_BYTES_PER_S = 3.35e12
F32_ADDS_PER_S = 67e12 / 2
HALF_RATE_OPS_PER_S = F32_ADDS_PER_S / 2
ISSUE_LANES_PER_S = F32_ADDS_PER_S
# per band cell: 6 f32 adds (G + W, and G, E, F plus open or extend, G's
# open shared by E and F); 9 f32 max, 6 f32 compares, 7 selects and 5
# integer ops (match test, code word) at half rate
SW_ADDS_PER_CELL = 6
SW_HALF_RATE_OPS_PER_CELL = 27


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call: `reps` calls queued behind a
    sleep kernel (so the host's enqueue time does not show), between two
    CUDA events.  The sleep lasts at least ~0.1 s and three times the
    host's enqueue time of `reps` calls, measured on one call first."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    one_s = time.perf_counter() - t0
    slept = torch.cuda.Event(enable_timing=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    slept.record()
    # the queue fills meanwhile (the SM clock runs at up to ~2 GHz)
    torch.cuda._sleep(int(max(2e8, 3 * reps * one_s * 2e9)))
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_s = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    # the device reached `start` after the sleep; every call must have been
    # queued by then, or the time would hold the host's gaps
    if enqueue_s * 1e3 >= slept.elapsed_time(start):
        raise AssertionError(f"{reps} calls took {enqueue_s:.3f} s to enqueue, "
                             f"longer than the sleep")
    return start.elapsed_time(end) / reps


def sw_bound(n: int, l: int) -> tuple[float, str]:
    """(least milliseconds, "bytes" or "operations") for banded SW of n
    pairs of length l: each input byte read once and each output byte
    written once over the HBM rate, against the recurrence's per-cell
    instructions: the busier of the two pipes, or the issue of all of
    them, whichever is slower."""
    cells = n * l * sw.BAND
    op_s = cells * max(
        SW_ADDS_PER_CELL / F32_ADDS_PER_S,
        SW_HALF_RATE_OPS_PER_CELL / HALF_RATE_OPS_PER_S,
        (SW_ADDS_PER_CELL + SW_HALF_RATE_OPS_PER_CELL) / ISSUE_LANES_PER_S)
    nbytes = n * ((2 * l + sw.BAND - 1) + 4 * sw.BAND
                  + 4 * sw.BAND * -(-l // sw.TB_PACK))
    byte_s = nbytes / HBM_BYTES_PER_S
    return max(op_s, byte_s) * 1e3, ("operations" if op_s >= byte_s
                                     else "bytes")


def sw_pairs(rng, n, l, offsets=None):
    """Random (query, window) pairs; the even ones are near-matches at a
    random band offset (or every pair, at `offsets` in turn) so real
    tracebacks are compared, not only the sentinel region."""
    q = rng.integers(0, 5, (n, l)).astype(np.uint8)
    db = rng.integers(0, 5, (n, l + sw.BAND - 1)).astype(np.uint8)
    rows = np.arange(0, n, 2) if offsets is None else np.arange(n)
    off = (rng.integers(0, sw.BAND, rows.size) if offsets is None
           else np.resize(np.asarray(offsets), rows.size))
    near = db[rows[:, None], off[:, None] + np.arange(l)[None, :]]
    mut = rng.random(near.shape) < 0.05
    q[rows] = np.where(mut, rng.integers(0, 4, near.shape), near)
    return q, db


def check_and_time(rng, dev, n: int, l: int, scores, time_it: bool,
                   offsets=None) -> dict:
    """banded_sw kernel vs banded_sw_torch on the same CUDA tensors (bit
    equality of gfin and tb) and, on up to 256 pairs, vs the numpy oracle;
    with time_it, CUDA-event times of both after a warm-up."""
    q, db = sw_pairs(rng, n, l, offsets)
    qd = torch.from_numpy(q).to(dev)
    dbd = torch.from_numpy(db).to(dev)
    g_k, tb_k = sw.banded_sw(qd, dbd, scores)
    g_p, tb_p = sw.banded_sw_torch(qd, dbd, scores)
    torch.cuda.synchronize()
    if not (torch.equal(g_k, g_p) and torch.equal(tb_k, tb_p)):
        raise AssertionError(
            f"banded_sw kernel != plain at N={n} L={l} {scores}: "
            f"{int((tb_k != tb_p).sum())} traceback words differ")
    m = min(n, 256)
    g_n, tb_n = sw.banded_sw_numpy_batch(q[:m], db[:m], scores)
    if not (np.array_equal(g_k[:m].cpu().numpy(), g_n)
            and np.array_equal(tb_k[:m].cpu().numpy(), tb_n)):
        raise AssertionError(f"banded_sw kernel != numpy oracle at N={n} "
                             f"L={l} {scores}")
    out = {"max_abs_err": float((g_k - g_p).abs().max())}
    if time_it:
        for _ in range(3):
            sw.banded_sw(qd, dbd, scores)
        out["ms"] = cuda_ms(lambda: sw.banded_sw(qd, dbd, scores), 200)
        t0 = time.perf_counter()
        for _ in range(3):
            sw.banded_sw_torch(qd, dbd, scores)
        torch.cuda.synchronize()
        out["plain_ms"] = (time.perf_counter() - t0) / 3 * 1e3
        out["gcups"] = n * l * sw.BAND / (out["ms"] * 1e-3) / 1e9
        out["bound_ms"], out["bound_by"] = sw_bound(n, l)
    return out


def walk_bound(rows: np.ndarray, l: int) -> float:
    """Least milliseconds for sw_walk over the HBM rate, from the bytes
    the work needs of these walks (their rows, on the host): per pair gfin
    and one 32-byte sector of traceback words for each group of TB_PACK
    query rows (the walk visits every row), the header and the runs it
    writes; for a gapped pair the query, the qualities and the window bases
    its M runs read; the two tables once.  Its work is a serial chain per
    pair, so no rate of operations bounds it."""
    n = len(rows)
    runs = rows[:, sw.WALK_HDR:]
    m_bases = np.where((runs & 3) == 0, runs >> 2, 0).sum(axis=1)
    gapped_rows = (rows[:, 2] & sw.WALK_GAPPED) != 0
    nbytes = (n * (4 * sw.BAND + 32 * -(-l // sw.TB_PACK) + 4 * sw.WALK_HDR)
              + 4 * int(rows[:, 1].sum())
              + int((2 * l + m_bases[gapped_rows]).sum())
              + 2 * 8 * sw.WALK_QUALS)
    return nbytes / HBM_BYTES_PER_S * 1e3


#: every batch's device program in this process, by the path it took
#: through graphs.ProgramGraphs.run (count_graph_paths)
GRAPH_PATHS = {"graph_replays": 0, "graph_captures": 0,
               "eager_dispatches": 0}


def count_graph_paths() -> None:
    """Add each dispatch's path (replayed as a CUDA graph, captured, or
    eager) to GRAPH_PATHS, whatever driver made it."""
    orig = graphs.ProgramGraphs.run

    def run(self, key, program, inputs, device, planes, tally):
        before = {k: getattr(tally, k) for k in GRAPH_PATHS}
        out = orig(self, key, program, inputs, device, planes, tally)
        for k in GRAPH_PATHS:
            GRAPH_PATHS[k] += getattr(tally, k) - before[k]
        return out
    graphs.ProgramGraphs.run = run


def dispatch_launches(al, inputs) -> str:
    """The CUDA runtime's launch calls and the device's kernels of one
    `_dispatch` of `al` in the profiler: eager (the aligner's graphs
    dropped, so the batch is a key's first sight) against replayed (the
    key captured by the dispatch after it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def one() -> str:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            al._dispatch(*inputs)
            torch.cuda.synchronize()
        calls: dict = {}
        kernels = 0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                kernels += not e.name.startswith(("Memcpy", "Memset"))
            elif e.name.startswith("cu") and ("Launch" in e.name
                                              or "Memcpy" in e.name):
                calls[e.name] = calls.get(e.name, 0) + 1
        return (f"{kernels} kernels, runtime calls "
                + ", ".join(f"{k} {v}" for k, v in sorted(calls.items())))

    al.graphs.clear()
    eager = one()
    al._dispatch(*inputs)
    torch.cuda.synchronize()
    return f"eager: {eager}; replayed: {one()}"


def reset_launches() -> None:
    """Zero both kernels' launch counters before a main path's run."""
    sw.banded_sw.launches = 0
    sw.sw_walk.launches = 0


def path_launches(what: str) -> int:
    """banded_sw's launches since reset_launches, after checking that
    sw_walk launched as often: on the card the gapped polish walks every
    banded_sw call's pairs with one sw_walk launch."""
    banded, walks = sw.banded_sw.launches, sw.sw_walk.launches
    if walks != banded:
        raise AssertionError(f"{what}: {walks} sw_walk launches for "
                             f"{banded} banded_sw launches")
    return banded


def check_and_time_walk(rng, dev, n: int, l: int, gs, time_it: bool) -> dict:
    """sw_walk kernel vs sw_walk_torch on the same CUDA tensors (every
    row, the float64 log-probability's words included), on pairs two
    thirds of which carry an indel; with time_it, the kernel's device time
    and the plain version's host wall of one call."""
    q, db, ql = synthetic.sw_walk_pairs(rng, n, l)
    qd, dbd, qld = (torch.from_numpy(x).to(dev) for x in (q, db, ql))
    g, tb = sw.banded_sw(qd, dbd, gs.sw_scores())
    args = (g, tb, qd, dbd, qld, *quality.log_tables_f64(dev), gs.norms())
    got = sw.sw_walk(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = sw.sw_walk_torch(*args)
    plain_ms = (time.perf_counter() - t0) * 1e3
    if not torch.equal(got, want):
        rows = int((got != want).any(dim=1).sum())
        raise AssertionError(f"sw_walk kernel != plain at N={n} L={l}: "
                             f"{rows} rows differ")
    gapped_frac = float(((want[:, 2] & sw.WALK_GAPPED) != 0).float().mean())
    out = {"gapped": gapped_frac}
    if time_it:
        out["ms"] = cuda_ms(lambda: sw.sw_walk(*args), 200)
        out["plain_ms"] = plain_ms
        out["bound_ms"] = walk_bound(want.cpu().numpy(), l)
    return out


def phase_walk(rng, dev) -> dict:
    """sw_walk kernel vs its plain version at the polish's launch sizes
    (timed), both gap scorings, ragged blocks and the longest query."""
    times = {}
    for gs in (gapped.BWA, gapped.ELAND):
        for n in WALK_PAIRS:
            t = check_and_time_walk(rng, dev, n, WALK_LEN, gs,
                                    time_it=gs is gapped.BWA)
            if "ms" in t:
                times[n] = t
        for n, l in ((1, WALK_LEN), (5, WALK_LEN), (896, 100),
                     (8, sw.MAX_LEN)):
            check_and_time_walk(rng, dev, n, l, gs, False)
    print(f"[3/18] kernel vs plain: sw_walk equal to sw_walk_torch, every "
          f"row (bwa+eland; N in {WALK_PAIRS} at L={WALK_LEN}, ragged N 1 "
          f"and 5, 896 x 100, 8 x {sw.MAX_LEN}); "
          + "; ".join(f"N={n} L={WALK_LEN} ({t['gapped']:.3f} gapped): "
                      f"kernel {t['ms']:.5f} ms (bound {t['bound_ms']:.5f} "
                      f"ms by bytes), plain {t['plain_ms']:.1f} ms"
                      for n, t in times.items()), flush=True)
    return times[WALK_PAIRS[-1]]


def phase_kernel(rng, dev) -> None:
    """Kernel vs plain version on the card (and the numpy oracle)."""
    shapes = ([(896, l) for l in SW_LENGTHS]
              + [(n, READ_LEN) for n in SW_BATCHES])
    for scores in (sw.BWA_SCORES, sw.ELAND_SCORES):
        for n, l in shapes:
            t = check_and_time(rng, dev, n, l, scores, time_it=(
                (n, l) == (SW_PAIRS, READ_LEN) and scores == sw.BWA_SCORES))
            if "ms" in t:
                timing = t
        check_and_time(rng, dev, 899, READ_LEN, scores, False,
                       offsets=[0, sw.BAND - 1])
    q = torch.zeros((3, sw.MAX_LEN + 1), dtype=torch.uint8, device=dev)
    db = torch.zeros((3, sw.MAX_LEN + sw.BAND), dtype=torch.uint8, device=dev)
    try:
        sw.banded_sw(q, db)
    except ValueError:
        pass
    else:
        raise AssertionError(f"banded_sw took L={sw.MAX_LEN + 1} > MAX_LEN")
    print(f"[3/18] kernel vs plain: banded_sw bit-equal to banded_sw_torch "
          f"(bwa+eland; L in {SW_LENGTHS} at N=896, N in {SW_BATCHES} at "
          f"L={READ_LEN}, band edges 0/15 at N=899) and to numpy on 256 "
          f"pairs; L={sw.MAX_LEN + 1} raises; N={SW_PAIRS} L={READ_LEN}: "
          f"kernel {timing['ms']:.5f} ms ({timing['gcups']:.1f} GCUPS, "
          f"bound {timing['bound_ms']:.5f} ms by {timing['bound_by']}), "
          f"plain {timing['plain_ms']:.2f} ms", flush=True)


def write_fastq(path: Path, bases: np.ndarray, prefix: str = "r") -> None:
    letters = np.frombuffer(b"ACGTN", np.uint8)[bases]
    qual = "?" * bases.shape[1]                       # phred 30
    with open(path, "w") as f:
        for i, row in enumerate(letters):
            f.write(f"@{prefix}{i}\n{row.tobytes().decode()}\n+\n{qual}\n")


def phase_slice(args, dev, card: str, tmp: Path):
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    genome = synthetic.make_genome(rng)
    index = build_index(genome, seed_len=32)
    sim = synthetic.make_reads(rng, genome.codes, N_BATCHES * BATCH,
                               read_len=READ_LEN, indel_frac=0.03, max_indel=8)
    fq = tmp / "reads.fq"
    write_fastq(fq, sim.bases)
    al = Aligner.create(index, read_len=READ_LEN, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    reset_launches()
    t0 = time.perf_counter()
    batch = read_fastq(fq)
    batches = [ReadBatch(names=batch.names[i:i + BATCH],
                         bases=batch.bases[i:i + BATCH],
                         quals=batch.quals[i:i + BATCH],
                         lengths=batch.lengths[i:i + BATCH])
               for i in range(0, batch.count, BATCH)]
    t_align = time.perf_counter()
    recs = [r for rs in al.align_to_sam_many(batches) for r in rs]
    align_s = time.perf_counter() - t_align
    write_sam(tmp / "out.sam", recs, genome.contigs)
    slice_s = time.perf_counter() - t0
    launches = path_launches('the slice')

    n = len(recs)
    idx = np.array([int(r.qname[1:]) for r in recs])
    mapped = np.array([r.is_mapped for r in recs])
    pos = np.array([r.pos - 1 for r in recs])
    placed = mapped & (np.abs(pos - sim.starts[idx]) <= 8)
    gapped = np.array([("I" in r.cigar or "D" in r.cigar) for r in recs])
    indel_reads = (sim.indel[idx] != 0) & mapped
    aligned_frac = float(mapped.mean())
    placed_frac = float(placed.mean())
    gapped_frac = float(gapped[indel_reads].mean())
    print(f"[4/18] slice: {genome.total_length} bp genome, "
          f"{index.num_records} index records, {n} reads in {N_BATCHES} "
          f"batches of {BATCH}: aligned {aligned_frac:.4f}, within 8 bp of "
          f"truth {placed_frac:.4f}, gapped CIGAR on {gapped_frac:.4f} of "
          f"mapped indel reads, banded_sw"
          f" and sw_walk launches {launches}; FASTQ->SAM "
          f"{n / slice_s:.1f} reads/s ({slice_s:.2f} s), align_to_sam_many "
          f"{n / align_s:.1f} reads/s ({align_s:.2f} s; dispatch "
          f"{al.timings['dispatch']:.2f} s, fetch {al.timings['fetch']:.2f} s, "
          f"polish {al.timings['polish']:.2f} s); setup {setup_s:.1f} s "
          f"[{card}]", flush=True)
    if n != N_BATCHES * BATCH:
        raise AssertionError(f"{n} records for {N_BATCHES * BATCH} reads")
    if aligned_frac < 0.95:
        raise AssertionError(f"aligned fraction {aligned_frac} < 0.95")
    if placed_frac < 0.95:
        raise AssertionError(f"placement fraction {placed_frac} < 0.95")
    if launches <= 0:
        raise AssertionError("the slice never launched the banded_sw kernel")
    if gapped_frac < 0.5:
        raise AssertionError(f"gapped CIGARs on only {gapped_frac} of the "
                             f"mapped indel reads")
    # the kernel again at the shape the slice gave it (mean pairs per launch)
    n_main = max(1, round(al.sw_pairs / launches))
    timing = check_and_time(rng, dev, n_main, READ_LEN, sw.BWA_SCORES, True)
    print(f"[4/18] banded_sw at the slice's shape (N={n_main} L={READ_LEN}, "
          f"{al.sw_pairs} pairs in {launches} launches): kernel "
          f"{timing['ms']:.5f} ms ({timing['gcups']:.1f} GCUPS, bound "
          f"{timing['bound_ms']:.5f} ms by {timing['bound_by']}), plain "
          f"{timing['plain_ms']:.2f} ms; SAM records "
          f"{al.timings['records']:.2f} s", flush=True)
    return genome, index, batches[0], al, timing


def run_workflow(index_dir: Path, fastq: Path | None, out: Path, device: str,
                 batch: int, fastq2: Path | None = None, **opts) -> dict:
    """AlignWorkflow at its defaults (or `opts`: another input than FASTQ
    with `fastq` None); returns the run's Stats JSON files and its saved
    state (TLS, finder stats)."""
    AlignWorkflow(WorkflowOptions(
        reference=str(index_dir), output_dir=str(out),
        fastq1=str(fastq) if fastq else None,
        fastq2=str(fastq2) if fastq2 else None, batch_size=batch,
        device=device, **opts)).run()
    out_stats = {name: json.loads((out / "Stats" / f"{name}.json").read_text())
                 for name in ("MatchSelectorStats", "BuildStats")}
    out_stats["state"] = json.loads(
        (out / "Temp" / "AlignerState.json").read_text())
    return out_stats


def phase_workflow(args, genome, index, card: str, tmp: Path):
    """FASTQ -> sorted BAM through the port's workflow on the card at the
    JAX benchmark's e2e_se size; returns (the kernel's launches, the
    simulated reads)."""
    rng = np.random.default_rng(args.seed + 2)
    t0 = time.perf_counter()
    index.save(tmp / "idx")
    sim = synthetic.make_reads(rng, genome.codes, WF_READS,
                               read_len=READ_LEN, indel_frac=0.03, max_indel=8)
    write_fastq(tmp / "wf.fq", sim.bases)
    write_fastq(tmp / "subset.fq", sim.bases[:WF_SUBSET])
    setup_s = time.perf_counter() - t0

    reset_launches()
    t0 = time.perf_counter()
    stats = run_workflow(tmp / "idx", tmp / "wf.fq", tmp / "wf", "cuda", BATCH)
    wall = time.perf_counter() - t0
    launches = path_launches('the single-end workflow')
    libs = native.loaded()

    t0 = time.perf_counter()
    aligned_frac, placed_frac = check_se_bam(tmp / "wf" / "sorted.bam",
                                             genome, sim)
    read_s = time.perf_counter() - t0
    ms, build = stats["MatchSelectorStats"], stats["BuildStats"]
    print(f"[5/18] workflow: {WF_READS} reads, FASTQ->BAM {WF_READS / wall:.1f} "
          f"reads/s ({wall:.2f} s; align_seconds {ms['align_seconds']:.2f} s: "
          f"{stage_split(ms)}; build_seconds {build['build_seconds']:.2f} s, "
          f"{build['bins']} bin(s), duplicates {build['duplicates']}, "
          f"realigned {build['realigned']}); aligned {aligned_frac:.4f}, "
          f"within 8 bp of truth {placed_frac:.4f}, banded_sw"
          f" and sw_walk launches "
          f"{launches}; native host libraries {libs}; BAM check {read_s:.1f} "
          f"s, setup {setup_s:.1f} s [{card}]", flush=True)
    if launches <= 0:
        raise AssertionError("the workflow never launched the banded_sw kernel")
    return launches, sim


def stage_split(ms: dict) -> str:
    return ", ".join(f"{k} {v:.2f} s" for k, v in ms["stage_seconds"].items())


class BamCore(NamedTuple):
    """The fields of a BAM record that the placement checks read."""
    qname: str
    flag: int
    rname: str
    pos: int            # 1-based, as SamRecord's

    @property
    def is_mapped(self) -> bool:
        return not self.flag & 4


def read_bam_core(path: Path) -> tuple[list, list]:
    """(contigs, records) of a BAM as `read_bam` gives them, each record
    with its name, flag, contig and position only: the bases, qualities,
    CIGAR and tags are skipped, which read_bam decodes in Python at ~20 us
    a record."""
    data = bgzf.decompress(Path(path).read_bytes())
    if data[:4] != b"BAM\x01":
        raise AssertionError(f"{path} is not a BAM file")
    off = 8 + struct.unpack_from("<i", data, 4)[0]
    n_ref = struct.unpack_from("<i", data, off)[0]
    off += 4
    refs = []
    for _ in range(n_ref):
        l_name = struct.unpack_from("<i", data, off)[0]
        refs.append((data[off + 4:off + 3 + l_name].decode(),
                     struct.unpack_from("<i", data, off + 4 + l_name)[0]))
        off += 8 + l_name
    names = [name for name, _len in refs]
    recs = []
    while off < len(data):
        size, ref_id, pos, l_rn = struct.unpack_from("<iiiB", data, off)
        flag = struct.unpack_from("<H", data, off + 18)[0]
        recs.append(BamCore(data[off + 36:off + 35 + l_rn].decode(), flag,
                            names[ref_id] if ref_id >= 0 else "*", pos + 1))
        off += 4 + size
    return refs, recs


def check_se_bam(out: Path, genome, sim) -> tuple[float, float]:
    """A single-end run's sorted.bam (`read_se_bam`), >= 0.95 aligned and
    within 8 bp of the truth; returns (aligned, placed) fractions."""
    mapped, placed = read_se_bam(out, genome, sim)
    aligned_frac = float(mapped.mean())
    placed_frac = float(placed.mean())
    if aligned_frac < 0.95 or placed_frac < 0.95:
        raise AssertionError(f"aligned {aligned_frac}, placed {placed_frac} "
                             f"< 0.95")
    return aligned_frac, placed_frac


def read_se_bam(out: Path, genome, sim) -> tuple[np.ndarray, np.ndarray]:
    """A single-end run's sorted.bam: one record a read, coordinate order,
    .bai and .md5; returns (mapped, within 8 bp of the truth in global
    coordinates), bool arrays in read order."""
    refs, recs = read_bam_core(out)
    offsets = {c.name: c.offset for c in genome.contigs}
    ref_index = {name: i for i, (name, _len) in enumerate(refs)}
    mapped = np.array([r.is_mapped for r in recs])
    idx = np.array([int(r.qname[1:]) for r in recs])
    gpos = np.array([offsets[r.rname] + r.pos - 1 if r.is_mapped else -1
                     for r in recs])
    keys = [(ref_index[r.rname], r.pos) for r in recs if r.is_mapped]
    ordered = all(a <= b for a, b in zip(keys, keys[1:]))
    first_unmapped = int(np.argmin(mapped)) if not mapped.all() else len(recs)
    placed = mapped & (np.abs(gpos - sim.starts[idx]) <= 8)
    if len(recs) != sim.starts.shape[0]:
        raise AssertionError(f"{len(recs)} BAM records for "
                             f"{sim.starts.shape[0]} reads")
    if not ordered or mapped[first_unmapped:].any():
        raise AssertionError(f"{out} is not in coordinate order")
    for ext in (".bai", ".md5"):
        if not Path(str(out) + ext).is_file():
            raise AssertionError(f"no {out.name}{ext}")
    order = np.argsort(idx)
    return mapped[order], placed[order]


def core_fields(path: Path) -> dict:
    """{qname: ((flag, pos, cigar, NM), mapq)} of a BAM's records."""
    return {r.qname: ((r.flag, r.pos, r.cigar, r.tags.get("NM")), r.mapq)
            for r in read_bam(path)[2]}


def mapq_flips(pairs) -> int:
    """Rows whose MAPQ differs; raises past the floor-flip bound (at most
    1 apart, on at most 0.5% of the rows)."""
    dq = np.array([abs(a - b) for a, b in pairs])
    flips = int((dq > 0).sum())
    if dq.max(initial=0) > 1 or flips > 0.005 * len(dq):
        raise AssertionError(f"MAPQ card vs CPU: max diff {dq.max()}, "
                             f"{flips} rows differ")
    return flips


def se_card_vs_cpu(tmp: Path, reference: Path, fastq: Path, name: str,
                   n: int, **opts) -> tuple[int, dict]:
    """The single-end workflow (`opts`) on the `n` reads of `fastq` on the
    card and on the CPU, into tmp/<name>_<device>: equal (qname, flag, pos,
    CIGAR, NM), MAPQ floor flips only.  Returns (the flips, the card run's
    `core_fields`)."""
    runs = {}
    for device in ("cuda", "cpu"):
        out = tmp / f"{name}_{device}"
        run_workflow(reference, fastq, out, device, n, **opts)
        runs[device] = core_fields(out / "sorted.bam")
    gpu, cpu = runs["cuda"], runs["cpu"]
    diff = [(q, gpu[q][0], cpu.get(q, (None,))[0]) for q in gpu
            if gpu[q][0] != cpu.get(q, (None,))[0]]
    if len(gpu) != n or gpu.keys() != cpu.keys() or diff:
        raise AssertionError(f"workflow {name} card vs CPU: core fields "
                             f"differ on {len(diff)} reads, e.g. {diff[:3]}")
    return mapq_flips((gpu[q][1], cpu[q][1]) for q in gpu), gpu


def phase_card_vs_cpu(tmp: Path, index, batch: ReadBatch,
                      al_gpu: Aligner) -> None:
    wf_flips, _ = se_card_vs_cpu(tmp, tmp / "idx", tmp / "subset.fq", "sub",
                                 WF_SUBSET)

    sub = ReadBatch(names=batch.names[:2048], bases=batch.bases[:2048],
                    quals=batch.quals[:2048], lengths=batch.lengths[:2048])
    gpu = al_gpu.align_to_sam(sub)
    cpu = Aligner.create(index, read_len=READ_LEN, device="cpu").align_to_sam(sub)

    def core(r):
        return (r.qname, r.flag, r.pos, r.cigar, r.tags.get("NM"))

    diff = [(g.qname, core(g), core(c)) for g, c in zip(gpu, cpu)
            if core(g) != core(c)]
    if len(gpu) != len(cpu) or diff:
        raise AssertionError(f"card vs CPU core fields differ on "
                             f"{len(diff)} rows, e.g. {diff[:3]}")
    flips = mapq_flips((g.mapq, c.mapq) for g, c in zip(gpu, cpu))
    print(f"[6/18] card vs CPU: workflow on {WF_SUBSET} reads, "
          f"qname/flag/pos/cigar/NM equal, MAPQ floor flips {wf_flips}; "
          f"library on {len(gpu)} reads, equal, MAPQ floor flips {flips}",
          flush=True)


def phase_paired_workflow(args, genome, card: str, tmp: Path):
    """Paired FASTQ -> sorted BAM through the port's workflow on the card
    at the JAX benchmark's e2e_pe size; returns (kernel launches, the
    simulated pairs, the learned TLS)."""
    rng = np.random.default_rng(args.seed + 3)
    t0 = time.perf_counter()
    sp = synthetic.make_pairs(rng, genome.codes, PE_PAIRS)
    for e, reads in ((1, sp.bases1), (2, sp.bases2)):
        write_fastq(tmp / f"pe{e}.fq", reads, "t")
        write_fastq(tmp / f"pe_sub{e}.fq", reads[:PE_SUBSET], "t")
    setup_s = time.perf_counter() - t0

    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    stats = run_workflow(tmp / "idx", tmp / "pe1.fq", tmp / "pe_wf", "cuda",
                         BATCH, fastq2=tmp / "pe2.fq")
    wall = time.perf_counter() - t0
    launches = path_launches('the paired workflow')
    working = working_set(mem0, [SeedIndex.load(tmp / "idx")])

    t0 = time.perf_counter()
    m = check_paired_bam(tmp / "pe_wf" / "sorted.bam", genome, sp, stats)
    read_s = time.perf_counter() - t0
    ms, build, tls = stats["MatchSelectorStats"], stats["BuildStats"], m["tls"]
    finder = stats["state"]["stats"].get("match_finder", {})
    work = ms["device_work"]
    n = PE_PAIRS
    print(f"[7/18] paired workflow: {n} pairs, {2 * n} records, FASTQ->BAM "
          f"{2 * n / wall:.1f} reads/s ({wall:.2f} s; align_seconds "
          f"{ms['align_seconds']:.2f} s: {stage_split(ms)}; build_seconds "
          f"{build['build_seconds']:.2f} s, {build['bins']} bin(s), "
          f"duplicates {build['duplicates']}, realigned "
          f"{build['realigned']}); learned {tls}; {m['summary']}; "
          f"proper_pairs {ms['proper_pairs']}, anomalous_pairs "
          f"{finder.get('anomalous_pairs')}, rescue_skipped "
          f"{finder.get('rescue_skipped', 0)}; banded_sw"
          f" and sw_walk launches {launches} "
          f"({work['sw_pairs']} pairs); rescue {work['rescue_rows']} rows in "
          f"{work['rescue_calls']} calls; {working}; BAM check {read_s:.1f} s, "
          f"setup {setup_s:.1f} s [{card}]", flush=True)
    if launches <= 0:
        raise AssertionError("the paired workflow never launched banded_sw")

    # the rescue alone at the shape the run gave it: the mean orphan rows
    # per call and the learned window, device time queued behind a sleep
    rows = max(1, round(work["rescue_rows"] / max(work["rescue_calls"], 1)))
    window = pairs.quantize_rescue_window(tls.mate_max - tls.mate_min + 1,
                                          4096)
    al = PairedAligner.create(SeedIndex.load(tmp / "idx"), read_len=READ_LEN,
                              device="cuda")
    sel = np.resize(np.nonzero(sp.damaged)[0], rows)
    args_r = [torch.from_numpy(x).to(al.device) for x in (
        sp.start1[sel], sp.reverse1[sel], sp.bases2[sel],
        np.full((rows, READ_LEN), 30, np.uint8))]

    def rescue():
        return pairs.rescue_shadows(al.arrays, al.cfg, tls, 0,
                                    (READ_LEN, READ_LEN), *args_r, window)
    found = float(rescue()["found"].float().mean())
    # 5 calls: each enqueues ~140 kernels, and more than the device's
    # launch queue holds behind the sleep would make the host wait
    rescue_ms = cuda_ms(rescue, 5)
    print(f"[7/18] rescue_shadows at the run's shape ({rows} rows x {window} "
          f"offsets x {READ_LEN} bases, damaged mates, found {found:.3f}): "
          f"{rescue_ms:.4f} ms a call, {work['rescue_calls']} calls in the "
          f"run", flush=True)
    # the kernel again at the shape the paired run gave it
    n_pe = max(1, round(work["sw_pairs"] / launches))
    timing = check_and_time(rng, al.device, n_pe, READ_LEN, sw.BWA_SCORES,
                            True)
    print(f"[7/18] banded_sw at the paired run's shape (N={n_pe} L={READ_LEN}, "
          f"{work['sw_pairs']} pairs in {launches} launches): kernel "
          f"{timing['ms']:.5f} ms ({timing['gcups']:.1f} GCUPS, bound "
          f"{timing['bound_ms']:.5f} ms by {timing['bound_by']}), plain "
          f"{timing['plain_ms']:.2f} ms", flush=True)
    return launches, sp, tls


def working_set(mem0: int, indexes: list, neighbors: bool = False) -> str:
    """The device working set beside the planes of the run of BATCH
    templates (reads or pairs) just ended (its peak less what was allocated
    before it and less the planes), held against the model that the
    workflow's group-major decision subtracts from the card's free memory;
    raises if the run took more than the model."""
    planes = sum(plane_bytes(ix) for ix in indexes)
    working = torch.cuda.max_memory_allocated() - mem0 - planes
    model = wfmod.batch_working_set(BATCH, READ_LEN, len(indexes), neighbors)
    if working > model:
        raise AssertionError(f"batch working set {working} B over the "
                             f"model's {model} B ({len(indexes)} groups)")
    return (f"batch working set {working} B ({working / BATCH:.1f} B a "
            f"template) beside {planes} B of planes, model {model} B")


def check_paired_bam(out: Path, genome, sp, stats: dict) -> dict:
    """A paired run's sorted.bam: two records a pair, coordinate order,
    .bai and .md5, per end >= 0.95 aligned and within 8 bp of the truth
    (global coordinates), proper pairs on >= 0.90 of the undamaged near
    pairs and on no far one whose mate holds no N (an N-island mate has no
    place of its own, and the rescue sets it beside read 1 as the JAX
    package does, ROADMAP §C5), >= 0.80 of the damaged mates rescued, and
    the learned TLS; returns the TLS and a summary line."""
    refs, recs = read_bam_core(out)
    offsets = {c.name: c.offset for c in genome.contigs}
    ref_index = {name: i for i, (name, _len) in enumerate(refs)}
    n = sp.start1.shape[0]
    mapped = np.zeros((2, n), bool)
    placed = np.zeros((2, n), bool)
    proper = np.zeros(n, bool)
    truth = (sp.start1, sp.start2)
    for r in recs:
        i = int(r.qname[1:])
        e = 0 if r.flag & 0x40 else 1
        if r.is_mapped:
            mapped[e, i] = True
            placed[e, i] = abs(offsets[r.rname] + r.pos - 1 - truth[e][i]) <= 8
        proper[i] |= bool(r.flag & 0x2)
    # an unmapped read with a mapped mate sits at its mate's coordinates
    placed_at = np.array([r.rname != "*" for r in recs])
    keys = [(ref_index[r.rname], r.pos) for r in recs if r.rname != "*"]
    ordered = all(a <= b for a, b in zip(keys, keys[1:]))
    first_unplaced = (int(np.argmin(placed_at)) if not placed_at.all()
                      else len(recs))
    tls = pairs.TlsStatic(**stats["state"]["tls"])
    normal = ~sp.damaged & ~sp.far
    far = sp.far & ~(sp.bases2 == 4).any(axis=1)
    proper_frac = float(proper[normal].mean())
    rescued_frac = float(placed[1, sp.damaged].mean())
    if len(recs) != 2 * n:
        raise AssertionError(f"{len(recs)} BAM records for {n} pairs")
    if not ordered or placed_at[first_unplaced:].any():
        raise AssertionError(f"paired {out} is not in coordinate order")
    for ext in (".bai", ".md5"):
        if not Path(str(out) + ext).is_file():
            raise AssertionError(f"no paired {out.name}{ext}")
    for e in (0, 1):
        if mapped[e].mean() < 0.95 or placed[e].mean() < 0.95:
            raise AssertionError(f"read {e + 1}: aligned {mapped[e].mean()}, "
                                 f"placed {placed[e].mean()} < 0.95")
    if proper_frac < 0.90 or proper[far].any():
        raise AssertionError(f"proper pairs {proper_frac} of the near pairs, "
                             f"{int(proper[far].sum())} far")
    if rescued_frac < 0.80:
        raise AssertionError(f"rescued {rescued_frac} < 0.80 of the damaged "
                             f"mates")
    if {tls.best0, tls.best1} != {1, 6} or abs(tls.median - 300) > 15:
        raise AssertionError(f"learned TLS {tls}")
    return {"tls": tls, "summary": (
        f"aligned {mapped[0].mean():.4f}/{mapped[1].mean():.4f}, within 8 bp "
        f"{placed[0].mean():.4f}/{placed[1].mean():.4f} (read 1/read 2); "
        f"proper {proper_frac:.4f} of {int(normal.sum())} undamaged near "
        f"pairs, {int(proper[far].sum())} of {int(far.sum())} far (and "
        f"{int(proper[sp.far & ~far].sum())} of {int((sp.far & ~far).sum())} "
        f"with an N-island mate); "
        f"rescued {rescued_frac:.4f} of {int(sp.damaged.sum())} damaged "
        f"mates")}


def pair_core(recs) -> dict:
    """{(qname, read): ((flag, pos, CIGAR, NM, RNEXT, PNEXT, TLEN), MAPQ)}"""
    return {(r.qname, r.flag & 0xC0): ((r.flag, r.pos, r.cigar,
                                        r.tags.get("NM"), r.rnext, r.pnext,
                                        r.tlen), r.mapq) for r in recs}


def compare_pairs(what: str, gpu: dict, cpu: dict, n: int) -> int:
    diff = [(k, gpu[k][0], cpu.get(k, (None,))[0]) for k in gpu
            if gpu[k][0] != cpu.get(k, (None,))[0]]
    if len(gpu) != 2 * n or gpu.keys() != cpu.keys() or diff:
        raise AssertionError(f"{what} card vs CPU: core fields differ on "
                             f"{len(diff)} records, e.g. {diff[:3]}")
    return mapq_flips((gpu[k][1], cpu[k][1]) for k in gpu)


def pe_card_vs_cpu(tmp: Path, name: str, **opts) -> tuple[dict, int]:
    """The paired workflow (`opts`) on phase 7's first PE_SUBSET pairs on
    the card and on the CPU, into tmp/<name>_<device>: the same TLS and
    core fields (MAPQ: floor flips only).  Returns (the TLS, the flips)."""
    runs = {}
    for device in ("cuda", "cpu"):
        out = tmp / f"{name}_{device}"
        st = run_workflow(tmp / "idx", tmp / "pe_sub1.fq", out, device,
                          PE_SUBSET, fastq2=tmp / "pe_sub2.fq", **opts)
        runs[device] = (st["state"]["tls"],
                        pair_core(read_bam(out / "sorted.bam")[2]))
    if runs["cuda"][0] != runs["cpu"][0]:
        raise AssertionError(f"{name}: learned TLS card {runs['cuda'][0]} vs "
                             f"CPU {runs['cpu'][0]}")
    return runs["cuda"][0], compare_pairs(f"paired workflow {name}",
                                          runs["cuda"][1], runs["cpu"][1],
                                          PE_SUBSET)


def phase_paired_card_vs_cpu(tmp: Path, sp, tls) -> None:
    learned, wf_flips = pe_card_vs_cpu(tmp, "pe_sub")

    index = SeedIndex.load(tmp / "idx")
    names = [f"t{i}" for i in range(PE_LIB)]

    def batches():
        return tuple(ReadBatch(names=names, bases=b[:PE_LIB].copy(),
                               quals=np.full((PE_LIB, READ_LEN), 30, np.uint8),
                               lengths=np.full(PE_LIB, READ_LEN, np.int32))
                     for b in (sp.bases1, sp.bases2))
    lib = {}
    for device in ("cuda", "cpu"):
        al = PairedAligner.create(index, read_len=READ_LEN, device=device)
        al.tls = tls
        lib[device] = pair_core(al.align_to_sam(*batches()))
    flips = compare_pairs("paired library", lib["cuda"], lib["cpu"], PE_LIB)
    print(f"[8/18] paired card vs CPU: workflow on {PE_SUBSET} pairs, TLS "
          f"{learned} equal, qname/flag/pos/cigar/NM/rnext/pnext/"
          f"tlen equal, MAPQ floor flips {wf_flips}; library on {PE_LIB} "
          f"pairs, equal, MAPQ floor flips {flips}", flush=True)


def write_fasta(path: Path, genome) -> None:
    letters = np.frombuffer(b"ACGTN", np.uint8)
    with open(path, "w") as f:
        for c in genome.contigs:
            seq = letters[genome.codes[c.offset:c.end]].tobytes().decode()
            f.write(f">{c.name}\n" + "\n".join(
                seq[i:i + 80] for i in range(0, len(seq), 80)) + "\n")


def unique_planes(index) -> tuple:
    """(unique k-mer word planes, inverse) of a 32-mer index's sorted key
    planes, as annotate_index dedups them."""
    words = [unbias_i32_to_u32(np.asarray(p))
             for p in (index.key_hi, index.key_lo)]
    new = np.ones(words[0].shape[0], bool)
    new[1:] = (words[0][1:] != words[0][:-1]) | (words[1][1:] != words[1][:-1])
    return tuple(w[new] for w in words), np.cumsum(new) - 1


def phase_sort_reference(args, card: str, tmp: Path):
    """sort-reference on the card: the phase-4 genome as eight contigs, two
    contig groups, annotated on "cuda"; returns the genome."""
    genome = synthetic.make_genome(np.random.default_rng(args.seed),
                                   n_contigs=N_CONTIGS)
    write_fasta(tmp / "ref8.fa", genome)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "isaac_aligner_tpu_torch", "sort-reference",
         "-g", str(tmp / "ref8.fa"), "-o", str(tmp / "idx8"),
         "--group-limit", str(GROUP_LIMIT)],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
        timeout=600)
    cli_s = time.perf_counter() - t0
    if proc.returncode:
        raise AssertionError(f"sort-reference failed: {proc.stdout}"
                             f"{proc.stderr}")
    manifest = json.loads((tmp / "idx8" / "multi-reference.json").read_text())
    names = split_genome_groups(genome.contigs, GROUP_LIMIT)
    if (manifest["groups"] != ["group_00", "group_01"]
            or manifest["total_length"] != genome.total_length
            or manifest["limit"] != GROUP_LIMIT
            or [len(g) for g in names] != [4, 4]):
        raise AssertionError(f"manifest {manifest} for groups {names}")
    # each group against an in-memory build and annotation on the card
    rows = []
    for gname, cnames in zip(manifest["groups"], names):
        disk = SeedIndex.load(tmp / "idx8" / gname)
        t0 = time.perf_counter()
        ref = build_index(subset_genome(genome, cnames), seed_len=32)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        bits = annotate_index(ref.key_hi, ref.key_lo, k=32, device="cuda")
        annot_s = time.perf_counter() - t0
        if [c.name for c in disk.genome.contigs] != cnames or not all(
                np.array_equal(getattr(disk, f), getattr(ref, f))
                for f in ("key_hi", "key_lo", "pos")):
            raise AssertionError(f"{gname}: planes differ from build_index")
        if not np.array_equal(disk.has_neighbors, bits.astype(np.uint8)):
            raise AssertionError(f"{gname}: neighbor bits differ")
        rows.append(f"{gname} {ref.num_records} records, build "
                    f"{build_s:.2f} s, annotation {annot_s:.2f} s, flagged "
                    f"{float(bits.mean()):.4f}")
    # contig 0 alone against the host oracle
    idx0 = build_index(subset_genome(genome, [genome.contigs[0].name]),
                       seed_len=32, annotate_neighbors=True, device="cuda")
    uniq, inverse = unique_planes(idx0)
    st: dict = {}
    t0 = time.perf_counter()
    dev_bits = find_neighbors_device(uniq, 32, device="cuda", stats=st)
    dev_s = time.perf_counter() - t0
    km = (uniq[0].astype(np.uint64) << np.uint64(32)) | uniq[1]
    t0 = time.perf_counter()
    host = find_neighbors(km, k=32)
    host_s = time.perf_counter() - t0
    if not np.array_equal(idx0.has_neighbors, dev_bits[inverse]):
        raise AssertionError("contig 0: build_index bits != the device program")
    # equal where no equal-prefix run exceeds the 256-row window; beyond
    # it the window sees a superset of the host's run-capped pairs
    if st["max_run"] <= 256 and not np.array_equal(dev_bits, host):
        raise AssertionError(f"contig 0: card {int(dev_bits.sum())} != host "
                             f"oracle {int(host.sum())} flagged k-mers")
    if (host & ~dev_bits).any():
        raise AssertionError("contig 0: the card missed oracle neighbors")
    # planted neighbors, card against the CPU
    planted = []
    for k in (16, 32, 64):
        planes = synthetic.planted_kmers(np.random.default_rng(args.seed + k),
                                         PLANTED, k)
        t0 = time.perf_counter()
        got = find_neighbors_device(planes, k, device="cuda")
        k_s = time.perf_counter() - t0
        want = find_neighbors_device(planes, k, device="cpu")
        if not np.array_equal(got, want):
            raise AssertionError(f"planted {k}-mers: card != CPU")
        planted.append(f"k={k} {int(got.sum())} of {got.size} in {k_s:.3f} s")
    print(f"[9/18] sort-reference: {N_CONTIGS} contigs, {genome.total_length} "
          f"bp, --group-limit {GROUP_LIMIT}: {len(names)} groups in "
          f"{cli_s:.2f} s (CLI process); {'; '.join(rows)}; contig 0 "
          f"({int(km.size)} unique 32-mers): card {int(dev_bits.sum())} "
          f"flagged in {dev_s:.2f} s, host oracle {int(host.sum())} in "
          f"{host_s:.2f} s, longest equal-prefix run {st['max_run']}, "
          f"{st['scan_steps']} scan steps; planted card == CPU: "
          f"{'; '.join(planted)} [{card}]", flush=True)
    return genome


@contextlib.contextmanager
def group_major(released: list | None = None):
    """Force group-major runs (a zero device budget); with `released`, the
    card's allocated bytes after every release_device append to it."""
    patched = [(wfmod, "device_memory_budget", lambda *_: 0)]
    if released is not None:
        for cls in (Aligner, PairedAligner):
            def rel(self, _orig=cls.release_device):
                _orig(self)
                if self.device.type == "cuda":
                    torch.cuda.synchronize()
                    released.append(torch.cuda.memory_allocated())
            patched.append((cls, "release_device", rel))
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patched]
    try:
        for obj, name, value in patched:
            setattr(obj, name, value)
        yield
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)


def print_kernel_at(phase: str, what: str, rng, pairs_sw: int,
                    launches: int) -> None:
    """The kernel against its plain version, and timed, at the mean pairs
    per launch that a run gave it (each group of a grouped run and each
    process polishes its own rows, so their launches are smaller than a
    single index's)."""
    n_g = max(1, round(pairs_sw / launches))
    timing = check_and_time(rng, torch.device("cuda"), n_g, READ_LEN,
                            sw.BWA_SCORES, True)
    print(f"[{phase}] banded_sw at the {what}'s shape (N={n_g} L={READ_LEN}, "
          f"{pairs_sw} pairs in {launches} launches): bit-equal to plain; "
          f"kernel {timing['ms']:.5f} ms ({timing['gcups']:.1f} GCUPS, bound "
          f"{timing['bound_ms']:.5f} ms by {timing['bound_by']}), plain "
          f"{timing['plain_ms']:.2f} ms", flush=True)


def phase_grouped_workflow(args, genome, card: str, tmp: Path) -> int:
    """FASTQ -> sorted BAM against the grouped directory, both groups
    resident; then a subset resident and group-major.  Returns the
    kernel's launches in the full run."""
    rng = np.random.default_rng(args.seed + 5)
    sim = synthetic.make_reads(rng, genome.codes, WF_READS,
                               read_len=READ_LEN, indel_frac=0.03, max_indel=8)
    write_fastq(tmp / "g_wf.fq", sim.bases)
    write_fastq(tmp / "g_sub.fq", sim.bases[:GM_SUBSET])
    reset_launches()
    t0 = time.perf_counter()
    stats = run_workflow(tmp / "idx8", tmp / "g_wf.fq", tmp / "g_wf", "cuda",
                         BATCH)
    wall = time.perf_counter() - t0
    launches = path_launches('the grouped workflow')
    aligned_frac, placed_frac = check_se_bam(tmp / "g_wf" / "sorted.bam",
                                             genome, sim)
    ms, build = stats["MatchSelectorStats"], stats["BuildStats"]
    if ms.get("group_major") is not False or len(ms["groups"]) != 2:
        raise AssertionError(f"groups {ms.get('groups')}, group_major "
                             f"{ms.get('group_major')}")
    if launches <= 0:
        raise AssertionError("the grouped workflow never launched banded_sw")
    finder = stats["state"]["stats"].get("match_finder", {})
    free, total = torch.cuda.mem_get_info()
    groups = "; ".join(f"{g['records']} records, {g['plane_bytes']} B of "
                       f"planes, upload {g['upload_seconds']:.3f} s"
                       for g in ms["groups"])
    print(f"[10/18] grouped workflow: {WF_READS} reads on {N_CONTIGS} "
          f"contigs in 2 groups, FASTQ->BAM {WF_READS / wall:.1f} reads/s "
          f"({wall:.2f} s; align_seconds {ms['align_seconds']:.2f} s: "
          f"{stage_split(ms)}; build_seconds {build['build_seconds']:.2f} s, "
          f"duplicates {build['duplicates']}, realigned {build['realigned']}"
          f"); aligned {aligned_frac:.4f}, within 8 bp of truth "
          f"{placed_frac:.4f} (pass-2 reads {finder.get('pass2_reads')}, "
          f"dropped {finder.get('pass2_dropped')}, over both groups); "
          f"banded_sw and sw_walk launches {launches} "
          f"({ms['device_work']['sw_pairs']} pairs); groups: {groups}; card "
          f"free {free} of {total} B [{card}]", flush=True)
    print_kernel_at("10/18", "grouped run", rng,
                    ms["device_work"]["sw_pairs"], launches)

    run_workflow(tmp / "idx8", tmp / "g_sub.fq", tmp / "g_res", "cuda", BATCH)
    released: list = []
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    with group_major(released):
        st = run_workflow(tmp / "idx8", tmp / "g_sub.fq", tmp / "g_gm",
                          "cuda", BATCH)
    if st["MatchSelectorStats"]["group_major"] is not True:
        raise AssertionError("the group-major run stayed resident")
    if (tmp / "g_gm" / "sorted.bam").read_bytes() != \
            (tmp / "g_res" / "sorted.bam").read_bytes():
        raise AssertionError("group-major sorted.bam != resident")
    if released != [base] * 2:
        raise AssertionError(f"allocated after each release {released}, "
                             f"baseline {base}")
    uploads = [g["upload_seconds"] for g in st["MatchSelectorStats"]["groups"]]
    print(f"[10/18] {GM_SUBSET} reads resident and group-major: sorted.bam "
          f"equal; allocated {released} B after the releases, baseline "
          f"{base} B; group-major uploads {uploads} s", flush=True)
    return launches


def phase_grouped_paired(args, genome, card: str, tmp: Path) -> int:
    """Paired FASTQ -> sorted BAM against the grouped directory, resident;
    then a subset group-major on the card and on the CPU.  Returns the
    kernel's launches in the full run."""
    rng = np.random.default_rng(args.seed + 6)
    sp = synthetic.make_pairs(rng, genome.codes, PE_PAIRS)
    for e, reads in ((1, sp.bases1), (2, sp.bases2)):
        write_fastq(tmp / f"gpe{e}.fq", reads, "t")
        write_fastq(tmp / f"gpe_sub{e}.fq", reads[:PE_SUBSET], "t")
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    stats = run_workflow(tmp / "idx8", tmp / "gpe1.fq", tmp / "gpe_wf",
                         "cuda", BATCH, fastq2=tmp / "gpe2.fq")
    wall = time.perf_counter() - t0
    launches = path_launches('the grouped paired workflow')
    working = working_set(mem0,
                          load_grouped_indexes(tmp / "idx8", mmap=True))
    m = check_paired_bam(tmp / "gpe_wf" / "sorted.bam", genome, sp, stats)
    ms, build = stats["MatchSelectorStats"], stats["BuildStats"]
    work = ms["device_work"]
    if ms.get("group_major") is not False or launches <= 0:
        raise AssertionError(f"group_major {ms.get('group_major')}, "
                             f"launches {launches}")
    print(f"[11/18] grouped paired workflow: {PE_PAIRS} pairs, FASTQ->BAM "
          f"{2 * PE_PAIRS / wall:.1f} reads/s ({wall:.2f} s; align_seconds "
          f"{ms['align_seconds']:.2f} s: {stage_split(ms)}; build_seconds "
          f"{build['build_seconds']:.2f} s); learned {m['tls']}; "
          f"{m['summary']}; banded_sw and sw_walk launches {launches} "
          f"({work['sw_pairs']} pairs); rescue {work['rescue_rows']} rows in "
          f"{work['rescue_calls']} calls; {working} [{card}]", flush=True)
    print_kernel_at("11/18", "grouped paired run", rng, work["sw_pairs"],
                    launches)

    runs = {}
    with group_major():
        for device in ("cuda", "cpu"):
            out = tmp / f"gpe_sub_{device}"
            st = run_workflow(tmp / "idx8", tmp / "gpe_sub1.fq", out, device,
                              PE_SUBSET, fastq2=tmp / "gpe_sub2.fq")
            if st["MatchSelectorStats"]["group_major"] is not True:
                raise AssertionError(f"{device}: the run stayed resident")
            runs[device] = (st["state"]["tls"],
                            pair_core(read_bam(out / "sorted.bam")[2]))
    if runs["cuda"][0] != runs["cpu"][0]:
        raise AssertionError(f"learned TLS card {runs['cuda'][0]} vs CPU "
                             f"{runs['cpu'][0]}")
    flips = compare_pairs("grouped paired workflow", runs["cuda"][1],
                          runs["cpu"][1], PE_SUBSET)
    print(f"[11/18] grouped card vs CPU, group-major: {PE_SUBSET} pairs, TLS "
          f"equal, qname/flag/pos/cigar/NM/rnext/pnext/tlen equal, MAPQ floor "
          f"flips {flips}", flush=True)
    return launches


def seedable(genome, sim, k: int) -> np.ndarray:
    """Reads with a k-base seed window (the default offsets) that equals
    the genome at the read's true start and holds no N: the reads that an
    exact k-mer seed can place.  bool [N] in read order."""
    n = sim.starts.shape[0]
    out = np.zeros(n, bool)
    cols = np.arange(k)
    step = 65_536
    for a in range(0, n, step):
        b = sim.bases[a:a + step]
        rc = b[:, ::-1]
        fwd = np.where(sim.reverse[a:a + step, None],
                       np.where(rc < 4, 3 - rc, rc), b)
        for off in default_seed_offsets(READ_LEN, k):
            ref = genome.codes[sim.starts[a:a + step, None] + off + cols]
            out[a:a + step] |= ((fwd[:, off:off + k] == ref)
                                & (ref < 4)).all(axis=1)
    return out


def phase_index64(args, genome, sim, card: str, tmp: Path) -> int:
    """`sort-reference -s 64` of phase 4's genome on the card, checked
    against an in-memory build and annotation; then phase 5's reads through
    the single-end workflow with -s 64 against it, and its first
    WF_SUBSET reads on the card and on the CPU.  Returns the kernel's
    launches in the full run."""
    rng = np.random.default_rng(args.seed + 7)
    write_fasta(tmp / "ref.fa", genome)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "isaac_aligner_tpu_torch", "sort-reference",
         "-g", str(tmp / "ref.fa"), "-o", str(tmp / "idx64"), "-s", "64"],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
        timeout=600)
    cli_s = time.perf_counter() - t0
    if proc.returncode:
        raise AssertionError(f"sort-reference -s 64 failed: {proc.stdout}"
                             f"{proc.stderr}")
    disk = SeedIndex.load(tmp / "idx64")
    t0 = time.perf_counter()
    ref = build_index(genome, seed_len=64)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bits = annotate_index(ref.key_hi, ref.key_lo, k=64, key_mids=ref.key_mids,
                          device="cuda")
    annot_s = time.perf_counter() - t0
    planes = [(getattr(disk, f), getattr(ref, f))
              for f in ("key_hi", "key_lo", "pos")]
    planes += list(zip(disk.key_mids, ref.key_mids))
    if (disk.seed_len != 64 or len(disk.key_mids) != 2
            or not all(np.array_equal(a, b) for a, b in planes)):
        raise AssertionError("sort-reference -s 64: planes differ from "
                             "build_index")
    if not np.array_equal(disk.has_neighbors, bits.astype(np.uint8)):
        raise AssertionError("sort-reference -s 64: neighbor bits differ")
    print(f"[12/18] sort-reference -s 64: {genome.total_length} bp, "
          f"{disk.num_records} records in {cli_s:.2f} s (CLI process); in "
          f"memory build {build_s:.2f} s, annotation on the card "
          f"{annot_s:.2f} s, flagged {float(bits.mean()):.4f}; planes and "
          f"neighbor bits equal; {plane_bytes(disk)} B of planes on the card "
          f"[{card}]", flush=True)

    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    stats = run_workflow(tmp / "idx64", tmp / "wf.fq", tmp / "wf64", "cuda",
                         BATCH, seed_len=64)
    wall = time.perf_counter() - t0
    launches = path_launches('the 64-mer workflow')
    working = working_set(mem0, [disk])
    mapped, placed = read_se_bam(tmp / "wf64" / "sorted.bam", genome, sim)
    ok = seedable(genome, sim, 64)
    aligned_ok = float(mapped[ok].mean())
    placed_aligned = float(placed[mapped].mean())
    ms, build = stats["MatchSelectorStats"], stats["BuildStats"]
    finder = stats["state"]["stats"].get("match_finder", {})
    print(f"[12/18] workflow -s 64 against the 64-mer index: {WF_READS} "
          f"reads, FASTQ->BAM {WF_READS / wall:.1f} reads/s ({wall:.2f} s; "
          f"align_seconds {ms['align_seconds']:.2f} s: {stage_split(ms)}; "
          f"build_seconds {build['build_seconds']:.2f} s); aligned "
          f"{float(mapped.mean()):.4f} of all reads and {aligned_ok:.4f} of "
          f"the {int(ok.sum())} with an exact N-free 64-mer seed window, "
          f"within 8 bp of truth {placed_aligned:.4f} of the aligned "
          f"(seeds without a match {finder.get('seeds_no_match')}, repeat-"
          f"suppressed {finder.get('seeds_too_many')}); banded_sw"
          f" and sw_walk launches "
          f"{launches} ({ms['device_work']['sw_pairs']} pairs); {working} "
          f"[{card}]",
          flush=True)
    if aligned_ok < 0.95 or placed_aligned < 0.95:
        raise AssertionError(f"-s 64: aligned {aligned_ok} of the seedable "
                             f"reads, placed {placed_aligned} of the aligned "
                             f"< 0.95")
    if launches <= 0:
        raise AssertionError("the 64-mer workflow never launched banded_sw")
    print_kernel_at("12/18", "64-mer run", rng, ms["device_work"]["sw_pairs"],
                    launches)
    flips, _ = se_card_vs_cpu(tmp, tmp / "idx64", tmp / "subset.fq", "sub64",
                              WF_SUBSET, seed_len=64)
    print(f"[12/18] card vs CPU, -s 64 against the 64-mer index: workflow on "
          f"{WF_SUBSET} reads, qname/flag/pos/cigar/NM equal, MAPQ floor "
          f"flips {flips}", flush=True)
    return launches


def phase_seed_options(args, genome, sim, sp, card: str, tmp: Path) -> int:
    """--neighborhood-size-threshold and --scatter-repeats on the 32-mer
    index: phase 7's pairs through the paired workflow with both, one
    library batch's neighbor hits, and each seed option alone on the card
    and on the CPU.  Returns the kernel's launches in the paired run."""
    rng = np.random.default_rng(args.seed + 8)
    opts = {"neighborhood_size_threshold": NB_THRESHOLD,
            "scatter_repeats": True}
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    stats = run_workflow(tmp / "idx", tmp / "pe1.fq", tmp / "pe_opts", "cuda",
                         BATCH, fastq2=tmp / "pe2.fq", **opts)
    wall = time.perf_counter() - t0
    launches = path_launches("the options' paired workflow")
    index = SeedIndex.load(tmp / "idx")
    working = working_set(mem0, [index], neighbors=True)
    m = check_paired_bam(tmp / "pe_opts" / "sorted.bam", genome, sp, stats)
    ms, build = stats["MatchSelectorStats"], stats["BuildStats"]
    work = ms["device_work"]
    print(f"[13/18] paired workflow with --neighborhood-size-threshold "
          f"{NB_THRESHOLD} --scatter-repeats 1: {PE_PAIRS} pairs, FASTQ->BAM "
          f"{2 * PE_PAIRS / wall:.1f} reads/s ({wall:.2f} s; align_seconds "
          f"{ms['align_seconds']:.2f} s: {stage_split(ms)}; build_seconds "
          f"{build['build_seconds']:.2f} s); learned {m['tls']}; "
          f"{m['summary']}; proper_pairs {ms['proper_pairs']}; banded_sw "
          f"launches {launches} ({work['sw_pairs']} pairs); rescue "
          f"{work['rescue_rows']} rows in {work['rescue_calls']} calls; "
          f"{working} [{card}]", flush=True)
    if launches <= 0:
        raise AssertionError("the options' paired workflow never launched "
                             "banded_sw")
    print_kernel_at("13/18", "options' paired run", rng, work["sw_pairs"],
                    launches)

    # one library batch with the threshold: the seed stage's neighbor hits
    cfg = AlignConfig(seed_offsets=default_seed_offsets(READ_LEN, 32),
                      neighborhood_size_threshold=NB_THRESHOLD)
    al = Aligner.create(index, read_len=READ_LEN, cfg=cfg, device="cuda")
    batch = ReadBatch(names=[f"r{i}" for i in range(BATCH)],
                      bases=sim.bases[:BATCH],
                      quals=np.full((BATCH, READ_LEN), 30, np.uint8),
                      lengths=np.full(BATCH, READ_LEN, np.int32))
    t0 = time.perf_counter()
    recs = al.align_to_sam(batch)
    lib_s = time.perf_counter() - t0
    diag = find_seed_hits(al.arrays, al.cfg,
                          torch.from_numpy(batch.bases).to(al.device))[4]
    nb = diag["neighbor_hits"].cpu().numpy()
    aligned = float(np.mean([r.is_mapped for r in recs]))
    al.release_device()
    if nb.sum() <= 0:
        raise AssertionError("the neighbor pass found no hit")
    print(f"[13/18] library batch of {BATCH} reads with the threshold: "
          f"{int(nb.sum())} neighbor hits on {int((nb > 0).sum())} reads, "
          f"aligned {aligned:.4f}, FASTQ->SAM {BATCH / lib_s:.1f} reads/s",
          flush=True)

    # each option alone, card vs CPU
    rows, card_runs = [], {}
    for name, ref, o in (
            ("-s 64 over the FASTA", tmp / "ref.fa", {"seed_len": 64}),
            (f"--neighborhood-size-threshold {NB_THRESHOLD}", tmp / "idx",
             {"neighborhood_size_threshold": NB_THRESHOLD}),
            ("--scatter-repeats 1", tmp / "idx", {"scatter_repeats": True})):
        flips, card_runs[name] = se_card_vs_cpu(
            tmp, ref, tmp / "subset.fq", f"opt{len(rows)}", WF_SUBSET, **o)
        rows.append(f"{name}: MAPQ floor flips {flips}")
    # the reads that the hash pick moved off phase 6's default placement
    default = core_fields(tmp / "sub_cuda" / "sorted.bam")
    scatter = card_runs["--scatter-repeats 1"]
    moved = sum(scatter[q][0][:2] != default[q][0][:2] for q in scatter)
    tls, flips = pe_card_vs_cpu(tmp, "pe_scatter", scatter_repeats=True)
    rows.append(f"paired --scatter-repeats 1: TLS {tls} equal, MAPQ floor "
                f"flips {flips}")
    print(f"[13/18] card vs CPU, each option alone on {WF_SUBSET} reads or "
          f"pairs, core fields equal: {'; '.join(rows)}; the single-end hash "
          f"pick moved {moved} reads off the default run's placement",
          flush=True)
    return launches


def spmd_diff(want: dict, got: dict) -> list:
    """Result fields of two drivers' align_batch_arrays that differ: every
    field the single-device result has, with the candidate grids compared
    in their valid slots (the padding follows the concatenated hit lists)
    and the device clip fields off the rows rescued in the program (the
    single-device driver re-clips those on the host, ROADMAP §C8)."""
    bad = [k for k in want if k not in got]
    for k in sorted(set(want) & set(got)):
        a, c = want[k], got[k]
        sfx = k[len(k.rstrip("_12")):]
        if isinstance(a, list):     # CIGARs
            if a != c:
                bad.append(k)
            continue
        if not isinstance(a, np.ndarray) or a.ndim == 0:
            if a != c:
                bad.append(k)
            continue
        keep = np.ones(a.shape[0], bool)
        if k.startswith("cand_") and not k.startswith("cand_valid"):
            keep = want["cand_valid" + sfx] & got["cand_valid" + sfx]
        elif k.startswith("sa_") and "rescued" + sfx in got:
            keep = ~got["rescued" + sfx]
        if keep.ndim < a.ndim:
            keep = np.broadcast_to(
                keep.reshape(keep.shape + (1,) * (a.ndim - keep.ndim)),
                a.shape)
        if a.shape != c.shape or not np.array_equal(np.where(keep, a, 0),
                                                    np.where(keep, c, 0)):
            bad.append(k)
    return bad


def timed_batch(al, inputs) -> tuple[dict, float, float]:
    """(align_batch_arrays result, its wall ms, the dispatch's ms between
    CUDA events: the device program with the host's enqueue gaps) of one
    batch, after two warm-up calls: the single-device drivers run the
    batch's first sight eagerly and capture it on the second, so the timed
    dispatch and batch are replays of its CUDA graph."""
    for _ in range(2):
        al.align_batch_arrays(*inputs)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    al._dispatch(*inputs)
    end.record()
    torch.cuda.synchronize()
    dispatch_ms = start.elapsed_time(end)
    t0 = time.perf_counter()
    res = al.align_batch_arrays(*inputs)
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3, dispatch_ms


def phase_spmd(args, genome, index, sim, sp, tls, card: str,
               tmp: Path) -> int:
    """The SPMD library over meshes of cuda:0 entries: ShardedAligner and
    ShardedPairedAligner against Aligner and PairedAligner on the card,
    every result field equal, and banded_sw held to its plain version at
    the sharded runs' mean pairs per launch; then collective duplicate
    marking over four entries against the per-bin marker on phase 7's
    records.  Returns the kernel's launches in the sharded runs."""
    from isaac_aligner_tpu_torch.build.dedup import (_dup_classes,
                                                     coordinate_sort_order,
                                                     mark_duplicates_batch,
                                                     mark_duplicates_collective)
    from isaac_aligner_tpu_torch.build.records import concat
    from isaac_aligner_tpu_torch.build.storage import BinnedFragmentStore
    from isaac_aligner_tpu_torch.parallel.sharded import Mesh, collective_dedup
    from isaac_aligner_tpu_torch.parallel.sharded_aligner import (
        ShardedAligner, ShardedPairedAligner)

    cuda0 = torch.device("cuda", 0)
    names = [f"t{i}" for i in range(SPMD_READS)]

    def batch(bases):
        return ReadBatch(names=list(names), bases=bases[:SPMD_READS].copy(),
                         quals=np.full((SPMD_READS, READ_LEN), 30, np.uint8),
                         lengths=np.full(SPMD_READS, READ_LEN, np.int32))
    launches, pairs_sw, rows = 0, 0, []
    for paired, inputs in ((False, (batch(sim.bases),)),
                           (True, (batch(sp.bases1), batch(sp.bases2)))):
        single = (PairedAligner if paired else Aligner).create(
            index, read_len=READ_LEN, device="cuda")
        if paired:
            single.tls = tls
        want, wall1, disp1 = timed_batch(single, inputs)
        what = "paired" if paired else "single-end"
        rows.append(f"{what} single device: batch {wall1:.1f} ms, dispatch "
                    f"{disp1:.1f} ms")
        if paired:
            print(f"[14/18] one paired dispatch of {SPMD_READS} pairs, "
                  f"{dispatch_launches(single, inputs)} [{card}]",
                  flush=True)
        single.release_device()
        for data, shard, gs in SPMD_MESHES:
            mesh = Mesh([[cuda0] * shard for _ in range(data)])
            cls = ShardedPairedAligner if paired else ShardedAligner
            al = cls.create_sharded(index, mesh=mesh, read_len=READ_LEN,
                                    genome_sharded=gs)
            if paired:
                al.tls = tls
            reset_launches()
            got = al.align_batch_arrays(*inputs)
            launches += path_launches('the sharded drivers')
            pairs_sw += al.sw_pairs
            bad = spmd_diff(want, got)
            mode = f"({data}, {shard}){' genome-sharded' if gs else ''}"
            if bad:
                raise AssertionError(f"{what} sharded {mode} != single "
                                     f"device on {bad}")
            if paired and int(got["rescue_dropped"]):
                raise AssertionError(f"{what} {mode}: rescue dropped "
                                     f"{int(got['rescue_dropped'])} rows")
            _res, wall, disp = timed_batch(al, inputs)
            rows.append(f"{what} {mode}: {len(want)} fields equal"
                        f", batch {wall:.1f} ms, dispatch "
                        f"{disp:.1f} ms")
            del al
    torch.cuda.empty_cache()
    print(f"[14/18] SPMD library, {SPMD_READS} reads and {SPMD_READS} pairs "
          f"over meshes of cuda:0 entries (a batch through "
          f"align_batch_arrays, wall, after two warm-ups; the dispatch "
          f"between CUDA events, a CUDA graph's replay on the single "
          f"device): {'; '.join(rows)}; banded_sw"
          f" and sw_walk launches {launches} "
          f"({pairs_sw} pairs) [{card}]", flush=True)
    if launches <= 0:
        raise AssertionError("the sharded drivers never launched banded_sw")
    print_kernel_at("14/18", "SPMD library", np.random.default_rng(
        args.seed + 14), pairs_sw, launches)

    # collective duplicate marking on phase 7's records, in Build order
    bins = tmp / "pe_wf" / "Temp" / "bins"
    parts = [BinnedFragmentStore.load_bin(d) for d in sorted(
        bins.glob("bin_*"))]
    parts += list(BinnedFragmentStore.iter_chunk_groups(bins / "unaligned",
                                                        1 << 30))
    fb = concat(parts)
    fb = fb.take(coordinate_sort_order(fb))
    mesh = Mesh([[cuda0] * DEDUP_DEVICES])
    t0 = time.perf_counter()
    want = mark_duplicates_batch(fb.take(np.arange(len(fb))),
                                 genome.contig_offsets)
    batch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = mark_duplicates_collective(fb.take(np.arange(len(fb))), mesh)
    coll_s = time.perf_counter() - t0
    _flags, overflow = collective_dedup(
        mesh, fb.anchor_self, fb.anchor_mate, fb.dup_rank, fb.dup_tie,
        _dup_classes(fb), fb.rg)
    dups = int(((want.flag & 0x400) != 0).sum())
    if len(fb) != 2 * PE_PAIRS or not np.array_equal(got.flag, want.flag):
        raise AssertionError(f"collective dedup of {len(fb)} records != "
                             f"mark_duplicates_batch")
    if int(overflow.sum()):
        raise AssertionError(f"collective dedup overflow {overflow}")
    print(f"[14/18] collective dedup over {DEDUP_DEVICES} cuda:0 entries: "
          f"{len(fb)} records of phase 7, flags equal to "
          f"mark_duplicates_batch ({dups} duplicates), overflow 0; "
          f"collective {coll_s:.3f} s, per-bin (host numpy) {batch_s:.3f} s",
          flush=True)
    return launches


def phase_multihost(args, tmp: Path, card: str) -> int:
    """scripts/torch_multihost_dryrun.py on phase 7's pairs: a
    single-process uniform_bins workflow on the card, then two processes
    (dist_processes=2, gloo control) sharing it; sorted.bam, .bai and .md5
    byte-equal and the merged stats counts equal; banded_sw held to its
    plain version at the two processes' mean pairs per launch.  Returns
    the two processes' kernel launches."""
    root = Path(__file__).resolve().parent
    proc = subprocess.run(
        [sys.executable, str(root / "scripts" / "torch_multihost_dryrun.py"),
         "--device", "cuda", "--out", str(tmp / "mh"),
         "--reference", str(tmp / "idx"), "--fastq1", str(tmp / "pe1.fq"),
         "--fastq2", str(tmp / "pe2.fq"), "--batch-size", str(BATCH),
         "--records-per-bin", str(MH_RECORDS_PER_BIN), "--timeout", "300"],
        cwd=root, capture_output=True, text=True, timeout=420)
    lines = proc.stdout.splitlines()
    if proc.returncode:
        raise AssertionError(f"multi-process dry run rc={proc.returncode}: "
                             f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    procs = [json.loads(ln) for ln in lines if ln.startswith('{"process"')]
    result = json.loads([ln for ln in lines
                         if ln.startswith('{"byte_identical"')][-1])
    if not (result["byte_identical"] and result["counts_equal"]) or \
            sorted(p["process"] for p in procs) != [0, 1]:
        raise AssertionError(f"multi-process dry run: {result}")
    launches = sum(p["launches"] for p in procs)
    pairs_sw = sum(p["sw_pairs"] for p in procs)
    if min(p["launches"] for p in procs) <= 0:
        raise AssertionError(f"a process never launched banded_sw: {procs}")
    if any(p["walk_launches"] != p["launches"] for p in procs):
        raise AssertionError(f"a process launched sw_walk and banded_sw "
                             f"unequally often: {procs}")
    split = "; ".join(
        f"process {p['process']}: align_seconds {p['align_seconds']:.2f} s "
        f"({', '.join(f'{k} {v:.2f} s' for k, v in p['stage_seconds'].items())}"
        f"), banded_sw"
        f" and sw_walk launches {p['launches']} ({p['sw_pairs']} pairs)"
        for p in procs)
    ms = result["counts"]["match_selector"]
    print(f"[15/18] multi-process workflow: {PE_PAIRS} pairs, 2 processes on "
          f"the card with gloo control against one uniform_bins process: "
          f"sorted.bam ({result['bam_bytes']} B), .bai and .md5 "
          f"byte-equal, counts equal (total_reads {ms['total_reads']}, "
          f"aligned {ms['aligned']}, proper_pairs {ms['proper_pairs']}); "
          f"single process {result['single_s']:.2f} s, two processes "
          f"{result['multi_s']:.2f} s (their start included); {split} "
          f"[{card}]", flush=True)
    print_kernel_at("15/18", "multi-process workflow",
                    np.random.default_rng(args.seed + 15), pairs_sw, launches)
    return launches


def expected_samples(observed: np.ndarray, barcodes: list) -> np.ndarray:
    """The sample each index read belongs to, reckoned here independently
    of the port's resolver: the one barcode within one substitution (an N
    counts as one), else -1 (unknown)."""
    codes = np.searchsorted(np.frombuffer(b"ACGT", np.uint8), np.stack(
        [np.frombuffer(b.encode(), np.uint8) for b in barcodes]))
    near = (observed[:, None, :] != codes[None]).sum(axis=2) <= 1
    return np.where(near.sum(axis=1) == 1, near.argmax(axis=1), -1)


def write_sheet(path: Path, rows: list) -> None:
    cols = ["barcode", "sample"] + (["reference"] if len(rows[0]) > 2 else [])
    path.write_text(",".join(cols) + "\n"
                    + "".join(",".join(map(str, r)) + "\n" for r in rows))


def pair_placement(recs, cluster_of: dict, offsets: dict, start1, start2,
                   n: int) -> tuple:
    """(mapped [2, n], within 8 bp of the truth [2, n], proper [n]) of
    `read_bam_core` records whose names `cluster_of` maps to a cluster."""
    mapped = np.zeros((2, n), bool)
    placed = np.zeros((2, n), bool)
    proper = np.zeros(n, bool)
    truth = (start1, start2)
    for r in recs:
        i = cluster_of[r.qname]
        e = 0 if r.flag & 0x40 else 1
        if r.is_mapped:
            mapped[e, i] = True
            placed[e, i] = abs(offsets[r.rname] + r.pos - 1 - truth[e][i]) <= 8
        proper[i] |= bool(r.flag & 0x2)
    return mapped, placed, proper


def check_sorted(path: Path, recs, refs) -> None:
    """Coordinate order (unplaced records last), .bai and .md5."""
    ref_index = {name: i for i, (name, _len) in enumerate(refs)}
    placed_at = np.array([r.rname != "*" for r in recs], bool)
    keys = [(ref_index[r.rname], r.pos) for r in recs if r.rname != "*"]
    first = int(np.argmin(placed_at)) if not placed_at.all() else len(recs)
    if not all(a <= b for a, b in zip(keys, keys[1:])) \
            or placed_at[first:].any():
        raise AssertionError(f"{path} is not in coordinate order")
    for ext in (".bai", ".md5"):
        if not Path(str(path) + ext).is_file():
            raise AssertionError(f"no {path}{ext}")


def demux_core(out: Path, samples) -> dict:
    """pair_core of every sample's sorted.bam, with RG and BC."""
    core = {}
    for s in samples:
        for r in read_bam(out / s / "sorted.bam")[2]:
            (key, (fields, mapq)), = pair_core([r]).items()
            core[key] = (fields + (r.tags.get("RG"), r.tags.get("BC")), mapq)
    return core


def phase_bcl(args, genome, sp, card: str, tmp: Path) -> int:
    """Phase 7's pairs as a demultiplexed BCL run folder through the
    workflow on the card; then a one-tile run folder on the card and on
    the CPU.  Returns the kernel's launches in the full run."""
    rng = np.random.default_rng(args.seed + 16)
    t0 = time.perf_counter()
    barcodes = synthetic.make_barcodes(rng, 4)
    observed, _planted, mism = synthetic.barcode_reads(rng, PE_PAIRS,
                                                       barcodes, 0.01, 0.02)
    pf = rng.random(PE_PAIRS) >= 0.05
    planted = synthetic.write_pair_run_folder(
        tmp / "run16", sp.bases1, sp.bases2, observed,
        [(1, "per_cycle", list(BCL_TILES)), (2, "bgzf", list(BCL_TILES))],
        pf=pf, clocs=True)
    samples = [f"S{k + 1}" for k in range(len(barcodes))]
    write_sheet(tmp / "sheet16.csv", list(zip(barcodes, samples)))
    setup_s = time.perf_counter() - t0
    names = [f"SIM:1:FCSIM:{lane}:{tile}:{x}:{y}" for lane, tile, x, y in zip(
        planted["lane"], planted["tile"], planted["x"], planted["y"])]
    cluster_of = {nm: i for i, nm in enumerate(names)}
    want = expected_samples(observed, barcodes)
    opts = dict(run_folder=str(tmp / "run16"),
                sample_sheet=str(tmp / "sheet16.csv"), per_tile_tls=True,
                bam_exclude_tags="none")

    reset_launches()
    t0 = time.perf_counter()
    stats = run_workflow(tmp / "idx", None, tmp / "bcl_wf", "cuda", BATCH,
                         **opts)
    wall = time.perf_counter() - t0
    launches = path_launches('the run-folder workflow')

    t0 = time.perf_counter()
    out = tmp / "bcl_wf"
    offsets = {c.name: c.offset for c in genome.contigs}
    counts = {}
    mapped = np.zeros((2, PE_PAIRS), bool)
    placed = np.zeros((2, PE_PAIRS), bool)
    proper = np.zeros(PE_PAIRS, bool)
    for k, s in enumerate(samples + ["unknown"]):
        refs, recs = read_bam_core(out / s / "sorted.bam")
        check_sorted(out / s / "sorted.bam", recs, refs)
        m, p, pr = pair_placement(recs, cluster_of, offsets, sp.start1,
                                  sp.start2, PE_PAIRS)
        mapped |= m
        placed |= p
        proper |= pr
        expect = int((pf & (want == (k if s != "unknown" else -1))).sum())
        counts[s] = len(recs) // 2
        if len(recs) != 2 * expect:
            raise AssertionError(f"{s}: {len(recs)} records, want "
                                 f"{2 * expect}")
    for e in (0, 1):
        if mapped[e, pf].mean() < 0.95 or placed[e, pf].mean() < 0.95:
            raise AssertionError(f"run folder read {e + 1}: aligned "
                                 f"{mapped[e, pf].mean()}, placed "
                                 f"{placed[e, pf].mean()} < 0.95")
    normal = pf & ~sp.damaged & ~sp.far
    proper_frac = float(proper[normal].mean())
    if proper_frac < 0.90:
        raise AssertionError(f"run folder: proper {proper_frac} < 0.90")
    by_tile = stats["state"]["tls_by_tile"]
    medians = {k: v["median"] for k, v in by_tile.items()}
    if len(medians) != 2 * len(BCL_TILES) or any(
            abs(v - 300) > 15 for v in medians.values()):
        raise AssertionError(f"per-tile TLS medians {medians}")
    # tags of the first sample's first records
    recs = read_bam(out / samples[0] / "sorted.bam")[2][:BCL_SUBSET]
    letters = np.frombuffer(b"ACGTN", np.uint8)
    for r in recs:
        i = cluster_of[r.qname]
        bc = letters[observed[i]].tobytes().decode()
        if (r.tags.get("ZX"), r.tags.get("ZY"), r.tags.get("BC"),
                r.tags.get("RG")) != (("i", int(planted["x"][i])),
                                      ("i", int(planted["y"][i])),
                                      ("Z", bc), ("Z", samples[0])):
            raise AssertionError(f"{r.qname}: tags {r.tags}")
    demux = json.loads((out / "Stats" / "DemultiplexingStats.json")
                       .read_text())
    if demux != {s: c for s, c in counts.items() if c}:
        raise AssertionError(f"DemultiplexingStats {demux} != {counts}")
    check_s = time.perf_counter() - t0
    ms, build = stats["MatchSelectorStats"], stats["BuildStats"]
    n_rec = 2 * int(pf.sum())
    print(f"[16/18] run folder: {PE_PAIRS} clusters in {2 * len(BCL_TILES)} "
          f"tiles (lane 1 .bcl.gz, lane 2 BGZF + .bci, .clocs), "
          f"{int(pf.sum())} passing the filter, {n_rec} records, BCL->BAM "
          f"{n_rec / wall:.1f} reads/s ({wall:.2f} s; align_seconds "
          f"{ms['align_seconds']:.2f} s: {stage_split(ms)}; build_seconds "
          f"{build['build_seconds']:.2f} s); samples {counts} (equal to an "
          f"independent barcode match; {int(mism.sum())} one-mismatch "
          f"barcodes); aligned {mapped[0, pf].mean():.4f}/"
          f"{mapped[1, pf].mean():.4f}, within 8 bp "
          f"{placed[0, pf].mean():.4f}/{placed[1, pf].mean():.4f}, proper "
          f"{proper_frac:.4f} of {int(normal.sum())} undamaged near pairs; "
          f"per-tile TLS medians {sorted(medians.values())}; ZX/ZY/BC/RG of "
          f"{len(recs)} records equal the planted ones; banded_sw"
          f" and sw_walk launches "
          f"{launches} ({ms['device_work']['sw_pairs']} pairs); checks "
          f"{check_s:.1f} s, setup {setup_s:.1f} s [{card}]", flush=True)
    if launches <= 0:
        raise AssertionError("the run-folder workflow never launched banded_sw")
    print_kernel_at("16/18", "run-folder run", rng,
                    ms["device_work"]["sw_pairs"], launches)

    n = BCL_SUBSET
    synthetic.write_pair_run_folder(
        tmp / "run16s", sp.bases1[:n], sp.bases2[:n], observed[:n],
        [(1, "per_cycle", [1101])], pf=pf[:n], clocs=True)
    runs = {}
    for device in ("cuda", "cpu"):
        o = tmp / f"bcl_sub_{device}"
        st = run_workflow(tmp / "idx", None, o, device, n,
                          **{**opts, "run_folder": str(tmp / "run16s")})
        runs[device] = ((st["state"]["tls"], st["state"]["tls_by_tile"]),
                        demux_core(o, samples + ["unknown"]))
    if runs["cuda"][0] != runs["cpu"][0]:
        raise AssertionError(f"run folder TLS card {runs['cuda'][0]} vs CPU "
                             f"{runs['cpu'][0]}")
    flips = compare_pairs("run-folder workflow", runs["cuda"][1],
                          runs["cpu"][1], int(pf[:n].sum()))
    print(f"[16/18] run folder card vs CPU: one tile of {n} clusters, TLS "
          f"and per-tile TLS equal, qname/flag/pos/cigar/NM/rnext/pnext/"
          f"tlen/RG/BC equal, MAPQ floor flips {flips}", flush=True)
    return launches


def phase_bam_input(args, genome, sp, card: str, tmp: Path) -> int:
    """Phase 7's sorted.bam realigned through the workflow on the card;
    the pairedness probe alone in a fresh process; phase 8's 4,096-pair
    BAM on the card and on the CPU.  Returns the kernel's launches."""
    src = tmp / "pe_wf" / "sorted.bam"
    root = Path(__file__).resolve().parent
    probe = subprocess.run(
        [sys.executable, "-c",
         "import json, resource, sys, time\n"
         "from isaac_aligner_tpu_torch.io.bam_input import reads_from_bam\n"
         "t0 = time.perf_counter()\n"
         "b1, b2 = reads_from_bam(sys.argv[1])\n"
         "print(json.dumps({'seconds': time.perf_counter() - t0, "
         "'peak_rss_kb': resource.getrusage(resource.RUSAGE_SELF).ru_maxrss,"
         " 'paired': b2 is not None, 'templates': b1.count}))\n",
         str(src)], cwd=root, capture_output=True, text=True, timeout=600)
    if probe.returncode:
        raise AssertionError(f"pairedness probe: {probe.stderr[-2000:]}")
    pr = json.loads(probe.stdout.splitlines()[-1])
    if not pr["paired"] or pr["templates"] != PE_PAIRS:
        raise AssertionError(f"pairedness probe {pr}")

    reset_launches()
    t0 = time.perf_counter()
    stats = run_workflow(tmp / "idx", None, tmp / "bam_wf", "cuda", BATCH,
                         bam_input=str(src))
    wall = time.perf_counter() - t0
    launches = path_launches('the BAM-input workflow')
    t0 = time.perf_counter()
    m = check_paired_bam(tmp / "bam_wf" / "sorted.bam", genome, sp, stats)
    ends_in = {(r.qname, r.flag & 0xC0) for r in read_bam_core(src)[1]}
    ends_out = {(r.qname, r.flag & 0xC0)
                for r in read_bam_core(tmp / "bam_wf" / "sorted.bam")[1]}
    if ends_in != ends_out:
        raise AssertionError("read 1 / read 2 identities changed")
    check_s = time.perf_counter() - t0
    ms, build = stats["MatchSelectorStats"], stats["BuildStats"]
    print(f"[17/18] BAM input: phase 7's sorted.bam, {2 * PE_PAIRS} records, "
          f"BAM->BAM {2 * PE_PAIRS / wall:.1f} reads/s ({wall:.2f} s; "
          f"align_seconds {ms['align_seconds']:.2f} s: {stage_split(ms)}; "
          f"build_seconds {build['build_seconds']:.2f} s); pairedness probe "
          f"(whole BAM read, fresh process) {pr['seconds']:.2f} s, peak RSS "
          f"{pr['peak_rss_kb'] / 1024:.1f} MiB; learned {m['tls']}; "
          f"{m['summary']}; read 1/read 2 identities kept; banded_sw "
          f"launches {launches} ({ms['device_work']['sw_pairs']} pairs); "
          f"checks {check_s:.1f} s [{card}]", flush=True)
    if launches <= 0:
        raise AssertionError("the BAM-input workflow never launched banded_sw")
    print_kernel_at("17/18", "BAM-input run", np.random.default_rng(
        args.seed + 17), ms["device_work"]["sw_pairs"], launches)

    runs = {}
    for device in ("cuda", "cpu"):
        o = tmp / f"bam_sub_{device}"
        st = run_workflow(tmp / "idx", None, o, device, PE_SUBSET,
                          bam_input=str(tmp / "pe_sub_cuda" / "sorted.bam"))
        runs[device] = (st["state"]["tls"],
                        pair_core(read_bam(o / "sorted.bam")[2]))
    if runs["cuda"][0] != runs["cpu"][0]:
        raise AssertionError(f"BAM input TLS card {runs['cuda'][0]} vs CPU "
                             f"{runs['cpu'][0]}")
    flips = compare_pairs("BAM-input workflow", runs["cuda"][1],
                          runs["cpu"][1], PE_SUBSET)
    print(f"[17/18] BAM input card vs CPU: phase 8's {PE_SUBSET}-pair BAM, "
          f"TLS equal, qname/flag/pos/cigar/NM/rnext/pnext/tlen equal, MAPQ "
          f"floor flips {flips}", flush=True)
    return launches


def phase_per_barcode(args, genome, genome8, card: str, tmp: Path) -> int:
    """FASTQ pairs plus a barcode FASTQ under a sample sheet with
    per-barcode references through the per-barcode driver on the card.
    Returns the kernel's launches."""
    rng = np.random.default_rng(args.seed + 18)
    t0 = time.perf_counter()
    share = (3 * PB_PAIRS // 8, 3 * PB_PAIRS // 8, PB_PAIRS // 8,
             PB_PAIRS // 8)
    parts = (synthetic.make_pairs(rng, genome.codes, share[0]),
             synthetic.make_pairs(rng, genome8.codes, share[1],
                                  insert=(500.0, 50.0),
                                  insert_range=(300, 700)),
             synthetic.make_pairs(rng, genome.codes, share[2]),
             synthetic.make_pairs(rng, genome.codes, share[3]))
    barcodes = synthetic.make_barcodes(rng, 3)
    order = rng.permutation(PB_PAIRS)
    cat = {f: np.concatenate([getattr(p, f) for p in parts])[order]
           for f in ("bases1", "bases2", "start1", "start2")}
    label = np.repeat(np.arange(4), share)[order]
    codes = np.searchsorted(np.frombuffer(b"ACGT", np.uint8), np.stack(
        [np.frombuffer(b.encode(), np.uint8) for b in barcodes]))
    observed = np.where((label < 3)[:, None], codes[np.minimum(label, 2)],
                        rng.integers(0, 4, (PB_PAIRS, 8))).astype(np.uint8)
    for e in (1, 2):
        write_fastq(tmp / f"pb{e}.fq", cat[f"bases{e}"], "p")
    write_fastq(tmp / "pb_i1.fq", observed, "p")
    write_sheet(tmp / "sheet18.csv", [
        (barcodes[0], "A", tmp / "idx"), (barcodes[1], "B", tmp / "idx8"),
        (barcodes[2], "C", "unmapped")])
    want = expected_samples(observed, barcodes)
    setup_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    reset_launches()
    t0 = time.perf_counter()
    wf = AlignWorkflow(WorkflowOptions(
        reference=str(tmp / "idx"), output_dir=str(tmp / "pb"),
        fastq1=str(tmp / "pb1.fq"), fastq2=str(tmp / "pb2.fq"),
        barcode_fastq=str(tmp / "pb_i1.fq"),
        sample_sheet=str(tmp / "sheet18.csv"), batch_size=BATCH,
        device="cuda"))
    wf.run()
    wall = time.perf_counter() - t0
    launches = path_launches('the per-barcode run')
    driver = getattr(wf, "per_barcode", None)
    if not isinstance(driver, PerBarcodeDriver) or \
            set(driver.device_bytes) != {"A", "B", "unknown"} or \
            any(b != base for b in driver.device_bytes.values()):
        raise AssertionError(f"allocated after the sub-workflows "
                             f"{getattr(driver, 'device_bytes', None)}, "
                             f"baseline {base}")
    out = tmp / "pb"
    per = json.loads((out / "Stats" / "PerBarcodeStats.json").read_text())
    cluster_of = {f"p{i}": i for i in range(PB_PAIRS)}
    rows = []
    sw_pairs = 0
    for k, s in enumerate(["A", "B", "C", "unknown"]):
        refs, recs = read_bam_core(out / s / "sorted.bam")
        sel = want == (k if k < 3 else -1)
        if len(recs) != 2 * int(sel.sum()) or per[s]["reads"] != len(recs):
            raise AssertionError(f"{s}: {len(recs)} records, stats "
                                 f"{per[s]['reads']}, want "
                                 f"{2 * int(sel.sum())}")
        if s == "C":
            if any(r.is_mapped for r in recs):
                raise AssertionError("an unmapped-reference read is mapped")
            rows.append(f"C {len(recs)} records, all unmapped")
            continue
        check_sorted(out / s / "sorted.bam", recs, refs)
        g = genome8 if s == "B" else genome
        offsets = {c.name: c.offset for c in g.contigs}
        _m, p, _proper = pair_placement(recs, cluster_of, offsets,
                                        cat["start1"], cat["start2"],
                                        PB_PAIRS)
        med = per[s]["tls"]["median"]
        if s != "unknown" and (p[0, sel].mean() < 0.95
                               or p[1, sel].mean() < 0.95):
            raise AssertionError(f"{s}: placed {p[0, sel].mean()}/"
                                 f"{p[1, sel].mean()} < 0.95")
        if abs(med - (500 if s == "B" else 300)) > (25 if s == "B" else 15):
            raise AssertionError(f"{s}: TLS median {med}")
        ms = json.loads((out / s / "Stats" / "MatchSelectorStats.json")
                        .read_text())
        sw_pairs += ms["device_work"]["sw_pairs"]
        rows.append(f"{s} {len(recs)} records, within 8 bp "
                    f"{p[0, sel].mean():.4f}/{p[1, sel].mean():.4f}, TLS "
                    f"median {med}")
    n_rec = 2 * PB_PAIRS
    print(f"[18/18] per-barcode driver: {PB_PAIRS} pairs + barcode FASTQ, "
          f"samples A (phase 5's index), B (phase 9's two groups), C "
          f"unmapped, unknown (the run's -r): {'; '.join(rows)} (counts "
          f"equal to an independent barcode match); FASTQ->BAM "
          f"{n_rec / wall:.1f} reads/s ({wall:.2f} s, every sample's passes "
          f"included); allocated after each sub-workflow "
          f"{driver.device_bytes} B, baseline {base} B; banded_sw"
          f" and sw_walk launches "
          f"{launches} ({sw_pairs} pairs); setup {setup_s:.1f} s [{card}]",
          flush=True)
    if launches <= 0:
        raise AssertionError("the per-barcode run never launched banded_sw")
    print_kernel_at("18/18", "per-barcode run", rng, sw_pairs, launches)
    return launches


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no GPU")
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[1/18] card: {card}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}", flush=True)

    for name in ("banded_sw", "sw_walk"):
        _build.load_kernel(name)
        report, build_s = _build.build_info(name)
        regs = [ln.strip() for ln in report.splitlines() if "registers" in ln
                or "spill" in ln]
        print(f"[2/18] built {name}.cu in {build_s:.1f} s: {'; '.join(regs)}",
              flush=True)

    phase_kernel(np.random.default_rng(args.seed + 1), dev)
    walk = phase_walk(np.random.default_rng(args.seed + 2), dev)
    # (phase, seconds from the start to its end)
    ends = [("1-3", time.perf_counter() - t_start)]
    count_graph_paths()
    paths = dict(GRAPH_PATHS)

    def done(phase: str) -> None:
        ends.append((phase, time.perf_counter() - t_start))
        print(f"[{phase}/18] device programs in this process: "
              + ", ".join(f"{k} {GRAPH_PATHS[k] - paths[k]}"
                          for k in GRAPH_PATHS), flush=True)
        paths.update(GRAPH_PATHS)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
        genome, index, batch0, al, timing = phase_slice(args, dev, card,
                                                        Path(d))
        done("4")
        se_launches, sim = phase_workflow(args, genome, index, card, Path(d))
        done("5")
        phase_card_vs_cpu(Path(d), index, batch0, al)
        done("6")
        pe_launches, sp, tls = phase_paired_workflow(args, genome, card,
                                                     Path(d))
        done("7")
        phase_paired_card_vs_cpu(Path(d), sp, tls)
        done("8")
        genome8 = phase_sort_reference(args, card, Path(d))
        done("9")
        gse_launches = phase_grouped_workflow(args, genome8, card, Path(d))
        done("10")
        gpe_launches = phase_grouped_paired(args, genome8, card, Path(d))
        done("11")
        i64_launches = phase_index64(args, genome, sim, card, Path(d))
        done("12")
        opt_launches = phase_seed_options(args, genome, sim, sp, card, Path(d))
        done("13")
        spmd_launches = phase_spmd(args, genome, index, sim, sp, tls, card,
                                   Path(d))
        done("14")
        mh_launches = phase_multihost(args, Path(d), card)
        done("15")
        bcl_launches = phase_bcl(args, genome, sp, card, Path(d))
        done("16")
        bam_launches = phase_bam_input(args, genome, sp, card, Path(d))
        done("17")
        pb_launches = phase_per_barcode(args, genome, genome8, card, Path(d))
        done("18")
    counts = (("single-end workflow", se_launches),
              ("paired workflow", pe_launches),
              ("grouped single-end workflow", gse_launches),
              ("grouped paired workflow", gpe_launches),
              ("64-mer workflow", i64_launches),
              ("paired workflow with the seed options", opt_launches),
              ("SPMD library", spmd_launches),
              ("multi-process workflow", mh_launches),
              ("run-folder workflow", bcl_launches),
              ("BAM-input workflow", bam_launches),
              ("per-barcode workflow", pb_launches))
    launches = sum(c for _, c in counts)
    per_phase = ", ".join(f"{p} {e - s:.1f} s" for (_, s), (p, e)
                          in zip([("", 0.0)] + ends, ends))
    print(f"banded_sw and sw_walk launches on the main paths (equal in "
          f"each): "
          f"{' + '.join(f'{what} {c}' for what, c in counts)} = {launches}; "
          f"all phases in {time.perf_counter() - t_start:.1f} s ({per_phase})",
          flush=True)
    jax_mods = sorted(m for m in sys.modules if m.startswith("jax")
                      or m.split(".")[0] == "isaac_aligner_tpu")
    if jax_mods:
        raise AssertionError(f"the port loaded JAX modules or the JAX "
                             f"package: {jax_mods[:5]}")

    print(json.dumps({"kernels": [{
        "name": "banded_sw", "route": "cuda",
        "source": "isaac_aligner_tpu_torch/ops/csrc/banded_sw.cu",
        "replaces": "isaac_aligner_tpu/ops/sw.py:237",
        "launches": launches, "max_abs_err": timing["max_abs_err"],
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        # no PyTorch call computes banded SW with a traceback
        "library_ms": None}, {
        "name": "sw_walk", "route": "cuda",
        "source": "isaac_aligner_tpu_torch/ops/csrc/sw_walk.cu",
        "replaces": None,
        # the main paths' runs, as banded_sw's: each path launched both
        # kernels equally often (path_launches, phase 15's processes)
        "launches": launches, "n": WALK_PAIRS[-1], "ms": walk["ms"],
        "plain_ms": walk["plain_ms"], "bound_ms": walk["bound_ms"],
        "bound_by": "bytes", "library_ms": None}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
