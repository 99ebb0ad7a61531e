"""Synthetic repeat-rich genomes and reads with known truth (numpy).

The genome recipe is the JAX package benchmark's E. coli-scale fixture
(bench.py make_genome): a random genome with diverged mobile-element
families pasted in (200 copies of a 600 bp element at 2% divergence, 30
copies of a 2 kb element at 1%) and a 1 kb N island.  Reads add 1%
substitutions, reverse-complement half of them, and give a fraction one
short insertion or deletion so the gapped polish has work.  Pairs
(`make_pairs`) follow the JAX benchmark's paired recipe (bench.py:361-377:
read 1 at the fragment start, read 2 the reverse complement of its end)
with a drawn insert length, both strands, damaged mates that only the
shadow rescue can place and far mates that make disjoined pairs.
Barcodes (`make_barcodes`, `barcode_reads`) and `write_pair_run_folder`
turn pairs into a demultiplexed Illumina run folder.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from .io import bcl
from .io.fasta import ContigMeta, Genome

#: (element length, copies, divergence) of the benchmark's families
ECOLI_FAMILIES = ((600, 200, 0.02), (2000, 30, 0.01))


def make_genome(rng: np.random.Generator, genome_len: int = 4_600_000,
                families=ECOLI_FAMILIES,
                n_island: tuple[int, int] = (3_000_000, 1000),
                n_contigs: int = 1) -> Genome:
    """Repeat-rich genome: random bases, each family's element pasted at
    random positions with per-copy divergence, and an N island
    (start, length).  Split into `n_contigs` equal contigs."""
    codes = rng.integers(0, 4, genome_len).astype(np.uint8)
    for elem_len, copies, divergence in families:
        elem = rng.integers(0, 4, elem_len).astype(np.uint8)
        for _ in range(copies):
            pos = int(rng.integers(0, genome_len - elem_len))
            mut = rng.random(elem_len) < divergence
            codes[pos : pos + elem_len] = np.where(
                mut, rng.integers(0, 4, elem_len), elem)
    island_start, island_len = n_island
    codes[island_start : island_start + island_len] = 4
    bounds = np.linspace(0, genome_len, n_contigs + 1).astype(int)
    contigs = [ContigMeta(index=i, name=f"sim{i}" if n_contigs > 1 else "ecoli_sim",
                          offset=int(bounds[i]),
                          length=int(bounds[i + 1] - bounds[i]), md5="0" * 32)
               for i in range(n_contigs)]
    return Genome(codes=codes, contigs=contigs)


@dataclasses.dataclass
class SimReads:
    bases: np.ndarray      # uint8 [N, L] read codes as sequenced
    starts: np.ndarray     # int64 [N] leftmost genome base of the source
    reverse: np.ndarray    # bool [N] read is the reverse complement
    indel: np.ndarray      # int64 [N] +k insertion, -k deletion, 0 none


def make_reads(rng: np.random.Generator, codes: np.ndarray, n: int,
               read_len: int = 100, mutate: float = 0.01,
               indel_frac: float = 0.03, max_indel: int = 8,
               margin: int = 20) -> SimReads:
    """`n` reads from `codes`: an indel_frac share carries one 1..max_indel
    bp insertion or deletion at least `margin` bases from either end,
    then `mutate` substitutions, then half are reverse complemented."""
    g = codes.shape[0]
    starts = rng.integers(0, g - read_len - max_indel, n)
    reads, indel = _reads_at(rng, codes, starts, read_len, mutate,
                             indel_frac, max_indel, margin)
    rev = rng.random(n) < 0.5
    reads = np.where(rev[:, None], _revcomp(reads), reads)
    return SimReads(bases=reads, starts=starts.astype(np.int64), reverse=rev,
                    indel=indel)


def _revcomp(reads: np.ndarray) -> np.ndarray:
    rc = reads[:, ::-1]
    return np.where(rc < 4, 3 - rc, rc).astype(np.uint8)


def _reads_at(rng: np.random.Generator, codes: np.ndarray,
              starts: np.ndarray, read_len: int, mutate: float,
              indel_frac: float, max_indel: int, margin: int):
    """Forward-strand reads at `starts`: an indel_frac share carries one
    1..max_indel bp insertion or deletion at least `margin` bases from
    either end, then `mutate` substitutions.  Returns (reads, indel)."""
    n = starts.shape[0]
    reads = codes[starts[:, None] + np.arange(read_len)[None, :]].copy()
    indel = np.zeros(n, np.int64)
    for i in np.nonzero(rng.random(n) < indel_frac)[0]:
        k = int(rng.integers(1, max_indel + 1))
        j = int(rng.integers(margin, read_len - margin))
        s = int(starts[i])
        if rng.random() < 0.5:        # deletion of k genome bases
            reads[i, j:] = codes[s + j + k : s + read_len + k]
            indel[i] = -k
        else:                         # insertion of k random bases
            reads[i, j : j + k] = rng.integers(0, 4, k)
            reads[i, j + k :] = codes[s + j : s + read_len - k]
            indel[i] = k
    mut = rng.random(reads.shape) < mutate
    reads = np.where(mut, rng.integers(0, 4, reads.shape), reads).astype(np.uint8)
    return reads, indel


def sw_walk_pairs(rng: np.random.Generator, n: int, l: int,
                  offsets=None) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(query uint8 [n, l], window uint8 [n, l + 15], qualities uint8
    [n, l]) for the banded SW and its traceback walk: windows of random
    codes with 2% N; each query copies its window from a random band offset
    (or from `offsets` in turn), two thirds of them with a 1-8 bp insertion
    or deletion at least 10 bases from either end (for l >= 30), then 1%
    substitutions and 2% N; qualities 2-41."""
    w = l + 15
    db = rng.integers(0, 4, (n, w)).astype(np.uint8)
    db[rng.random(db.shape) < 0.02] = 4
    off = (rng.integers(0, 16, n) if offsets is None
           else np.resize(np.asarray(offsets), n))
    q = np.empty((n, l), np.uint8)
    for k in range(n):
        # past the window's end the read runs on into random bases
        src = np.concatenate([db[k, off[k]:], rng.integers(0, 4, 8)])
        kind = int(rng.integers(0, 3)) if l >= 30 else 0
        ln = int(rng.integers(1, 9))
        j = int(rng.integers(10, l - 10)) if kind else 0
        if kind == 1:                 # insertion of ln random bases
            row = np.concatenate([src[:j], rng.integers(0, 4, ln), src[j:]])
        elif kind == 2:               # deletion of ln window bases
            row = np.concatenate([src[:j], src[j + ln:]])
        else:
            row = src
        q[k] = row[:l]
    sub = rng.random(q.shape) < 0.01
    q = np.where(sub, rng.integers(0, 4, q.shape), q).astype(np.uint8)
    q[rng.random(q.shape) < 0.02] = 4
    quals = rng.integers(2, 42, (n, l)).astype(np.uint8)
    return q, db, quals


def worst_case_walk_tb(l: int) -> np.ndarray:
    """Packed traceback codes [ceil(l/5), 16] (`ops.sw.pack_tb`) whose walk
    from (l-1, 15) changes op at every step: M and D down the band to d = 0,
    then I and D in turn to the first row; ~2l runs, against the 2l + 15
    that `ops.sw.walk_runs` allows."""
    from .ops import sw

    codes = np.zeros((l, sw.BAND), np.int32)
    i, d, state, down = l - 1, sw.BAND - 1, 0, True
    while i >= 0:
        if state == 0:                        # G: to E, or to F at d = 0
            nxt = 1 if d > 0 else 2
            codes[i, d] |= nxt
            down = down and nxt == 1
            i -= 1
        elif state == 1:                      # E: back to G, or to F
            nxt = 0 if down else 2
            codes[i, d] |= nxt << 2
            d -= 1
        else:                                 # F: to E
            nxt = 1
            codes[i, d] |= nxt << 4
            i -= 1
            d += 1
        state = nxt
    return sw.pack_tb(codes)


def polish_batch(rng: np.random.Generator, genome: Genome, n: int,
                 read_len: int = 100, trigger: int = 5):
    """A paired batch as the gapped polish finds it after the pair step:
    `res` with each end's ("_1", "_2") aligned, start (the read's source,
    as an ungapped placement), reverse, mismatches (of that placement, or
    trigger + 1 on a quarter of the rows, so that some gapped results lose),
    edit_distance, log_prob (float32; 0 or -1000 on some rows), others_sum,
    log_scale, frag_score, mapq and cigar (a clip CIGAR on a few rows, which the
    polish passes over), in the dtypes the aligner gives them; half the
    reads carry a 1-8 bp indel.  Returns (res, {suffix: (bases, quals)})."""
    res: dict = {}
    ends = {}
    for sfx in ("_1", "_2"):
        sim = make_reads(rng, genome.codes, n, read_len, indel_frac=0.5)
        fwd = np.where(sim.reverse[:, None], _revcomp(sim.bases), sim.bases)
        ref = genome.codes[sim.starts[:, None] + np.arange(read_len)]
        mm = (fwd != ref).sum(axis=1).astype(np.int32)
        mm[rng.random(n) < 0.25] = trigger + 1
        lp = (-3.5 * mm - rng.random(n)).astype(np.float32)
        lp[rng.random(n) < 0.1] = 0.0
        lp[rng.random(n) < 0.1] = -1000.0
        cigar = [None] * n
        for r in rng.choice(n, 4, replace=False):
            cigar[r] = f"{read_len - 5}M5S"
        res.update({
            "aligned" + sfx: rng.random(n) < 0.95,
            "start" + sfx: sim.starts.astype(np.int32),
            "reverse" + sfx: sim.reverse,
            "mismatches" + sfx: mm,
            "edit_distance" + sfx: mm.copy(),
            "log_prob" + sfx: lp,
            "others_sum" + sfx: (rng.random(n) * 1e-3).astype(np.float32),
            "log_scale" + sfx: rng.uniform(-2, 2, n).astype(np.float32),
            "frag_score" + sfx: rng.integers(0, 60, n).astype(np.int32),
            "mapq" + sfx: rng.integers(0, 61, n).astype(np.int32),
            "cigar" + sfx: cigar})
        ends[sfx] = (sim.bases,
                     rng.integers(2, 42, sim.bases.shape).astype(np.uint8))
    return res, ends


def planted_kmers(rng: np.random.Generator, n: int, k: int) -> tuple:
    """Up to `n` unique random k-mers as unbiased uint32 word planes (most
    significant first, 16 bases a word) where every other one is a
    1-4 base mutation of its predecessor: a neighbor annotation input
    with known neighbors."""
    n_words = max(1, 2 * k // 32)
    bits = 2 * k // n_words
    bases_per_word = k // n_words
    w = rng.integers(0, 1 << bits, (n, n_words), dtype=np.uint64)
    for i in range(0, n - 1, 2):
        w[i + 1] = w[i]
        for _ in range(int(rng.integers(1, 5))):
            word, off = divmod(int(rng.integers(0, k)), bases_per_word)
            w[i + 1, word] ^= np.uint64(rng.integers(1, 4)) << np.uint64(
                bits - 2 - 2 * off)
    w = np.unique(w.astype(np.uint32), axis=0)
    return tuple(w[:, j] for j in range(n_words))


@dataclasses.dataclass
class SimPairs:
    bases1: np.ndarray     # uint8 [N, L] read 1 as sequenced
    bases2: np.ndarray     # uint8 [N, L] read 2 as sequenced
    start1: np.ndarray     # int64 [N] leftmost genome base of read 1
    start2: np.ndarray     # int64 [N] leftmost genome base of read 2
    reverse1: np.ndarray   # bool [N] read 1 is the reverse complement
    reverse2: np.ndarray   # bool [N]
    insert: np.ndarray     # int64 [N] drawn fragment length
    damaged: np.ndarray    # bool [N] read 2 carries a substitution every 10th base
    far: np.ndarray        # bool [N] read 2 drawn >= far_min bases away


def make_pairs(rng: np.random.Generator, codes: np.ndarray, n: int,
               read_len: int = 100, mutate: float = 0.01,
               indel_frac: float = 0.03, max_indel: int = 8,
               insert: tuple[float, float] = (300.0, 50.0),
               insert_range: tuple[int, int] = (150, 500),
               damaged_frac: float = 0.02, far_frac: float = 0.005,
               far_min: int = 100_000, margin: int = 20) -> SimPairs:
    """`n` read pairs from `codes`.  Fragment lengths are drawn from
    N(insert) clipped to insert_range; half the fragments come from each
    strand, so the pairs are FRp (read 1 forward at the fragment start,
    read 2 the reverse complement of its end) or RFm.  Each end gets
    make_reads' substitutions and indels.  A damaged_frac share of read 2s
    gets a substitution at every 10th base, which kills every 32-mer seed
    but stays under the rescue's 25% mismatch cap; a far_frac share of
    read 2s is drawn at least far_min bases from read 1 (disjoined
    pairs)."""
    g = codes.shape[0]
    frag = np.clip(np.rint(rng.normal(insert[0], insert[1], n)),
                   insert_range[0], insert_range[1]).astype(np.int64)
    p = rng.integers(0, g - insert_range[1] - max_indel, n)
    fwd = rng.random(n) < 0.5
    lo, hi = p, p + frag - read_len
    start1 = np.where(fwd, lo, hi)
    start2 = np.where(fwd, hi, lo)
    far = rng.random(n) < far_frac
    if far.any() and g < 2 * far_min + read_len + max_indel:
        raise ValueError(f"far mates need a genome of at least "
                         f"{2 * far_min + read_len + max_indel} bp")
    for i in np.nonzero(far)[0]:
        q = start1[i]
        while abs(q - start1[i]) < far_min:
            q = int(rng.integers(0, g - read_len - max_indel))
        start2[i] = q
    r1, _ = _reads_at(rng, codes, start1, read_len, mutate, indel_frac,
                      max_indel, margin)
    r2, _ = _reads_at(rng, codes, start2, read_len, mutate, indel_frac,
                      max_indel, margin)
    r1 = np.where(fwd[:, None], r1, _revcomp(r1))
    r2 = np.where(fwd[:, None], _revcomp(r2), r2)
    damaged = (rng.random(n) < damaged_frac) & ~far
    cols = np.arange(0, read_len, 10)
    sub = r2[damaged][:, cols]
    shifted = (sub + rng.integers(1, 4, sub.shape)) % 4
    r2[np.ix_(np.nonzero(damaged)[0], cols)] = np.where(sub < 4, shifted, sub)
    return SimPairs(bases1=r1.astype(np.uint8), bases2=r2.astype(np.uint8),
                    start1=start1.astype(np.int64),
                    start2=start2.astype(np.int64),
                    reverse1=~fwd, reverse2=fwd.copy(), insert=frag,
                    damaged=damaged, far=far)


def make_barcodes(rng: np.random.Generator, n: int, length: int = 8,
                  min_distance: int = 3) -> list[str]:
    """`n` random barcodes of `length` bases, each pair at Hamming
    distance >= min_distance (so one mismatch still resolves)."""
    out: list[np.ndarray] = []
    while len(out) < n:
        c = rng.integers(0, 4, length).astype(np.uint8)
        if all(int((c != o).sum()) >= min_distance for o in out):
            out.append(c)
    return ["".join("ACGT"[x] for x in c) for c in out]


def barcode_reads(rng: np.random.Generator, n: int, barcodes: list[str],
                  mismatch_frac: float = 0.01, random_frac: float = 0.02
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Index reads of `n` clusters: each carries barcodes[i % len], a
    mismatch_frac share with one substituted base, a random_frac share a
    random barcode instead.  Returns (codes uint8 [n, length], the planted
    sample index or -1 for the random ones, the one-mismatch mask)."""
    codes = np.stack([np.frombuffer(b.encode(), np.uint8) for b in barcodes])
    codes = np.searchsorted(np.frombuffer(b"ACGT", np.uint8), codes)
    sample = np.arange(n) % len(barcodes)
    out = codes[sample].astype(np.uint8)
    length = out.shape[1]
    u = rng.random(n)
    mism = u < mismatch_frac
    rand = (u >= mismatch_frac) & (u < mismatch_frac + random_frac)
    rows = np.nonzero(mism)[0]
    col = rng.integers(0, length, rows.size)
    out[rows, col] = (out[rows, col] + rng.integers(1, 4, rows.size)) % 4
    out[rand] = rng.integers(0, 4, (int(rand.sum()), length))
    return out, np.where(rand, -1, sample), mism


def write_pair_run_folder(run_folder, bases1: np.ndarray, bases2: np.ndarray,
                          index: np.ndarray, lanes, pf: np.ndarray | None = None,
                          quals: int = 30, clocs: bool = False,
                          flowcell: str = "FCSIM") -> dict:
    """An Illumina run folder of paired clusters, cycles y<L>,i<B>,y<L>
    (read 1, index read, read 2), written with the port's writers.

    `lanes` is [(lane, layout, tiles)]: layout "per_cycle" (one .bcl.gz a
    cycle and tile, a .filter a tile) or "bgzf" (the NextSeq layout: one
    BGZF .bcl.bgzf a cycle holding the lane's tiles, s_<lane>.bci and one
    lane filter).  Clusters go to the tiles in order, equal shares (the
    last tile takes the rest); `pf` (default all) marks those passing the
    filter.  Every tile gets cluster positions, one cluster per 25-unit
    bin with offsets drawn from a generator seeded by the cluster count:
    .clocs with `clocs`, else .locs.  Returns
    the planted per-cluster "lane", "tile", "x" and "y" (the CASAVA
    integers read names and ZX/ZY carry)."""
    run = Path(run_folder)
    n, read_len = bases1.shape
    pf = np.ones(n, bool) if pf is None else np.asarray(pf, bool)
    info = bcl.RunInfo(flowcell=flowcell, instrument="SIM", run_number=1,
                       reads=[bcl.ReadSegment(1, read_len, False),
                              bcl.ReadSegment(2, index.shape[1], True),
                              bcl.ReadSegment(3, read_len, False)],
                       lane_count=max(lane for lane, _l, _t in lanes))
    rng = np.random.default_rng(n)
    out = {k: np.zeros(n, np.int64) for k in ("lane", "tile", "x", "y")}
    n_tiles = sum(len(tiles) for _lane, _l, tiles in lanes)
    share = n // n_tiles
    at = 0
    for li, (lane, layout, tiles) in enumerate(lanes):
        bgzf_tiles = []
        for ti, tile in enumerate(tiles):
            last = li == len(lanes) - 1 and ti == len(tiles) - 1
            rows = np.arange(at, n if last else at + share)
            at = rows[-1] + 1
            k = np.arange(rows.size)
            dx = rng.integers(0, 250, rows.size)
            dy = rng.integers(0, 250, rows.size)
            bx, by = k % 82, k // 82
            x = bx * 25 + dx / 10.0
            y = by * 25 + dy / 10.0
            out["lane"][rows], out["tile"][rows] = lane, tile
            out["x"][rows] = 250 * bx + dx + 1000
            out["y"][rows] = 250 * by + dy + 1000
            segs = [(b[rows], np.full((rows.size, b.shape[1]), quals,
                                      np.uint8))
                    for b in (bases1, index, bases2)]
            pos = run / "Data" / "Intensities" / f"L{lane:03d}"
            if layout == "per_cycle":
                bcl.write_run_folder(run, info, lane, tile, segs, pf=pf[rows],
                                     x=x, y=y, compress=True)
            elif layout == "bgzf":
                bgzf_tiles.append((tile, segs))
                pos.mkdir(parents=True, exist_ok=True)
                bcl.write_locs(pos / f"s_{lane}_{tile}.locs", x, y)
            else:
                raise ValueError(f"unknown run-folder layout {layout!r}")
            if clocs:
                (pos / f"s_{lane}_{tile}.locs").unlink()
                bcl.write_clocs(pos / f"s_{lane}_{tile}.clocs", x, y)
        if bgzf_tiles:
            bcl.write_run_folder_bgzf(run, info, lane, bgzf_tiles)
            lane_pf = pf[out["lane"] == lane]
            bcl.write_filter(run / "Data" / "Intensities" / "BaseCalls"
                             / f"L{lane:03d}" / f"s_{lane}.filter", lane_pf)
    return out
