#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Drives the port's single-end main paths at the benchmark's E. coli scale:
the library (FASTQ -> Aligner.create(..., device="cuda") ->
align_to_sam_many -> SAM) and the workflow users run (FASTQ ->
AlignWorkflow on "cuda" -> sorted, duplicate-marked, gap-realigned BAM
with .bai and .md5), and checks every hand-written kernel on their path
against its plain torch version.  Phases, one line each:

  1. the card (torch.cuda must be available) with its name and power limit;
  2. build the CUDA kernels from the repo's sources (nvcc, sm_90a);
  3. kernel vs plain: banded SW with BWA and ELAND scores at L in
     {1, 4, 5, 100, 101, 150, 251, 400} (896 pairs) and N in {1, 3, 896,
     8,192, 65,537} (L=100), and with every pair a near-match at band
     offset 0 or 15, bit-equal to `banded_sw_torch` on the same CUDA
     tensors and, on 256 pairs, to the numpy oracle; L over the kernel's
     limit raises; times both at 8,192 x 100 (and again at the slice's own
     launch shape after phase 4, the times the kernel line reports);
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
     the same SAM core fields.

It imports only torch, numpy and the port, and fails if any `jax*` or
`isaac_aligner_tpu` module was loaded by the end.

Then one JSON line of kernel results (launches: the workflow's run of
phase 5), the card line, and the last line {"ok": true, "device": {...}}.
Any failed check raises: the exit code is non-zero and no result line is
printed.

    python3 chip_smoke.py [--seed N]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

# phase 5's output process is spawned and re-imports this file under the
# name __mp_main__: it needs none of these (it imports its own host modules)
if __name__ != "__mp_main__":
    import torch

    from isaac_aligner_tpu_torch import synthetic
    from isaac_aligner_tpu_torch.aligner import Aligner
    from isaac_aligner_tpu_torch.index.build import build_index
    from isaac_aligner_tpu_torch.io.bam import read_bam
    from isaac_aligner_tpu_torch.io.fastq import ReadBatch, read_fastq
    from isaac_aligner_tpu_torch.io.sam import write_sam
    from isaac_aligner_tpu_torch.native import build as native
    from isaac_aligner_tpu_torch.ops import _build, sw
    from isaac_aligner_tpu_torch.workflow.align import (AlignWorkflow,
                                                        WorkflowOptions)

READ_LEN = 100
BATCH = 32_768
N_BATCHES = 4
WF_READS = 524_288          # the JAX benchmark's e2e_se size (bench.py:62)
WF_SUBSET = 4_096
SW_PAIRS = 8_192
SW_LENGTHS = (1, 4, 5, 100, 101, 150, 251, 400)
SW_BATCHES = (1, 3, 896, 8_192, 65_537)

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
    CUDA events."""
    slept = torch.cuda.Event(enable_timing=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    slept.record()
    torch.cuda._sleep(200_000_000)         # ~0.1 s: the queue fills meanwhile
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
    print(f"[3/6] kernel vs plain: banded_sw bit-equal to banded_sw_torch "
          f"(bwa+eland; L in {SW_LENGTHS} at N=896, N in {SW_BATCHES} at "
          f"L={READ_LEN}, band edges 0/15 at N=899) and to numpy on 256 "
          f"pairs; L={sw.MAX_LEN + 1} raises; N={SW_PAIRS} L={READ_LEN}: "
          f"kernel {timing['ms']:.5f} ms ({timing['gcups']:.1f} GCUPS, "
          f"bound {timing['bound_ms']:.5f} ms by {timing['bound_by']}), "
          f"plain {timing['plain_ms']:.2f} ms", flush=True)


def write_fastq(path: Path, bases: np.ndarray) -> None:
    letters = np.frombuffer(b"ACGTN", np.uint8)[bases]
    qual = "?" * bases.shape[1]                       # phred 30
    with open(path, "w") as f:
        for i, row in enumerate(letters):
            f.write(f"@r{i}\n{row.tobytes().decode()}\n+\n{qual}\n")


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

    sw.banded_sw.launches = 0
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
    launches = sw.banded_sw.launches

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
    print(f"[4/6] slice: {genome.total_length} bp genome, "
          f"{index.num_records} index records, {n} reads in {N_BATCHES} "
          f"batches of {BATCH}: aligned {aligned_frac:.4f}, within 8 bp of "
          f"truth {placed_frac:.4f}, gapped CIGAR on {gapped_frac:.4f} of "
          f"mapped indel reads, banded_sw launches {launches}; FASTQ->SAM "
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
    print(f"[4/6] banded_sw at the slice's shape (N={n_main} L={READ_LEN}, "
          f"{al.sw_pairs} pairs in {launches} launches): kernel "
          f"{timing['ms']:.5f} ms ({timing['gcups']:.1f} GCUPS, bound "
          f"{timing['bound_ms']:.5f} ms by {timing['bound_by']}), plain "
          f"{timing['plain_ms']:.2f} ms; SAM records "
          f"{al.timings['records']:.2f} s", flush=True)
    return genome, index, batches[0], al, timing


def run_workflow(index_dir: Path, fastq: Path, out: Path, device: str,
                 batch: int) -> dict:
    """AlignWorkflow at its defaults; returns the run's Stats JSON files."""
    AlignWorkflow(WorkflowOptions(
        reference=str(index_dir), output_dir=str(out), fastq1=str(fastq),
        batch_size=batch, device=device)).run()
    return {name: json.loads((out / "Stats" / f"{name}.json").read_text())
            for name in ("MatchSelectorStats", "BuildStats")}


def phase_workflow(args, genome, index, card: str, tmp: Path) -> int:
    """FASTQ -> sorted BAM through the port's workflow on the card at the
    JAX benchmark's e2e_se size; returns the kernel's launches."""
    rng = np.random.default_rng(args.seed + 2)
    t0 = time.perf_counter()
    index.save(tmp / "idx")
    sim = synthetic.make_reads(rng, genome.codes, WF_READS,
                               read_len=READ_LEN, indel_frac=0.03, max_indel=8)
    write_fastq(tmp / "wf.fq", sim.bases)
    write_fastq(tmp / "subset.fq", sim.bases[:WF_SUBSET])
    setup_s = time.perf_counter() - t0

    sw.banded_sw.launches = 0
    t0 = time.perf_counter()
    stats = run_workflow(tmp / "idx", tmp / "wf.fq", tmp / "wf", "cuda", BATCH)
    wall = time.perf_counter() - t0
    launches = sw.banded_sw.launches
    libs = native.loaded()

    out = tmp / "wf" / "sorted.bam"
    t0 = time.perf_counter()
    _text, refs, recs = read_bam(out)
    read_s = time.perf_counter() - t0
    offsets = {c.name: c.offset for c in genome.contigs}
    ref_index = {name: i for i, (name, _len) in enumerate(refs)}
    mapped = np.array([r.is_mapped for r in recs])
    idx = np.array([int(r.qname[1:]) for r in recs])
    gpos = np.array([offsets[r.rname] + r.pos - 1 if r.is_mapped else -1
                     for r in recs])
    keys = [(ref_index[r.rname], r.pos) for r in recs if r.is_mapped]
    ordered = all(a <= b for a, b in zip(keys, keys[1:]))
    first_unmapped = int(np.argmin(mapped)) if not mapped.all() else len(recs)
    aligned_frac = float(mapped.mean())
    placed_frac = float((mapped & (np.abs(gpos - sim.starts[idx]) <= 8)).mean())
    ms, build = stats["MatchSelectorStats"], stats["BuildStats"]
    stages = ", ".join(f"{k} {v:.2f} s" for k, v in ms["stage_seconds"].items())
    print(f"[5/6] workflow: {len(recs)} reads, FASTQ->BAM {WF_READS / wall:.1f} "
          f"reads/s ({wall:.2f} s; align_seconds {ms['align_seconds']:.2f} s: "
          f"{stages}; build_seconds {build['build_seconds']:.2f} s, "
          f"{build['bins']} bin(s), duplicates {build['duplicates']}, "
          f"realigned {build['realigned']}); aligned {aligned_frac:.4f}, "
          f"within 8 bp of truth {placed_frac:.4f}, banded_sw launches "
          f"{launches}; native host libraries {libs}; read_bam {read_s:.1f} "
          f"s, setup {setup_s:.1f} s [{card}]", flush=True)
    if len(recs) != WF_READS:
        raise AssertionError(f"{len(recs)} BAM records for {WF_READS} reads")
    if not ordered or mapped[first_unmapped:].any():
        raise AssertionError("sorted.bam is not in coordinate order")
    for ext in (".bai", ".md5"):
        if not Path(str(out) + ext).is_file():
            raise AssertionError(f"no sorted.bam{ext}")
    if aligned_frac < 0.95:
        raise AssertionError(f"aligned fraction {aligned_frac} < 0.95")
    if placed_frac < 0.95:
        raise AssertionError(f"placement fraction {placed_frac} < 0.95")
    if launches <= 0:
        raise AssertionError("the workflow never launched the banded_sw kernel")
    return launches


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


def phase_card_vs_cpu(tmp: Path, index, batch: ReadBatch,
                      al_gpu: Aligner) -> None:
    runs = {}
    for device in ("cuda", "cpu"):
        run_workflow(tmp / "idx", tmp / "subset.fq", tmp / f"sub_{device}",
                     device, WF_SUBSET)
        runs[device] = core_fields(tmp / f"sub_{device}" / "sorted.bam")
    gpu, cpu = runs["cuda"], runs["cpu"]
    diff = [(q, gpu[q][0], cpu.get(q, (None,))[0]) for q in gpu
            if gpu[q][0] != cpu.get(q, (None,))[0]]
    if len(gpu) != WF_SUBSET or gpu.keys() != cpu.keys() or diff:
        raise AssertionError(f"workflow card vs CPU: core fields differ on "
                             f"{len(diff)} reads, e.g. {diff[:3]}")
    wf_flips = mapq_flips((gpu[q][1], cpu[q][1]) for q in gpu)

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
    print(f"[6/6] card vs CPU: workflow on {WF_SUBSET} reads, "
          f"qname/flag/pos/cigar/NM equal, MAPQ floor flips {wf_flips}; "
          f"library on {len(gpu)} reads, equal, MAPQ floor flips {flips}",
          flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no GPU")
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[1/6] card: {card}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}", flush=True)

    _build.load_kernel("banded_sw")
    report, build_s = _build.build_info("banded_sw")
    regs = [ln.strip() for ln in report.splitlines() if "registers" in ln
            or "spill" in ln]
    print(f"[2/6] built banded_sw.cu in {build_s:.1f} s: {'; '.join(regs)}",
          flush=True)

    phase_kernel(np.random.default_rng(args.seed + 1), dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
        genome, index, batch0, al, timing = phase_slice(args, dev, card,
                                                        Path(d))
        launches = phase_workflow(args, genome, index, card, Path(d))
        phase_card_vs_cpu(Path(d), index, batch0, al)
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
        "library_ms": None}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
