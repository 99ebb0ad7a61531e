"""Synthetic repeat-rich genomes and reads with known truth (numpy).

The genome recipe is the JAX package benchmark's E. coli-scale fixture
(bench.py make_genome): a random genome with diverged mobile-element
families pasted in (200 copies of a 600 bp element at 2% divergence, 30
copies of a 2 kb element at 1%) and a 1 kb N island.  Reads add 1%
substitutions, reverse-complement half of them, and give a fraction one
short insertion or deletion so the gapped polish has work.
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
    rev = rng.random(n) < 0.5
    rc = reads[:, ::-1]
    rc = np.where(rc < 4, 3 - rc, rc).astype(np.uint8)
    reads = np.where(rev[:, None], rc, reads)
    return SimReads(bases=reads, starts=starts.astype(np.int64), reverse=rev,
                    indel=indel)
