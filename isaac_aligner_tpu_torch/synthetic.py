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
"""

from __future__ import annotations

import dataclasses

import numpy as np

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
