"""The benchmark's frozen generators: reference genomes and read libraries
with planted truth (numpy only).

A frozen copy of `isaac_aligner_tpu_torch/synthetic.py` (`make_genome`,
`_reads_at`, `_revcomp`, `make_pairs`), extended here and kept under the
benchmark so that no change to the program moves the yardstick:

- genomes are laid out from a configuration's `genome` block: named
  contigs, repeat families given by copies or by genome share with a
  divergence range per copy, segmental duplications copied from the
  genome itself, and one central N block a contig;
- libraries are drawn from a recipe (`libraries/<name>.json`): insert
  distribution, substitutions, indels (whose read position is kept as
  truth), damaged and far mates, duplicate fragments, and qualities in
  binned levels that fall toward the 3' end.

Nothing here imports the program: the harness turns these arrays into the
program's input types.
"""

from __future__ import annotations

import dataclasses
import gzip
from pathlib import Path

import numpy as np

ACGTN = np.frombuffer(b"ACGTN", np.uint8)


@dataclasses.dataclass
class SimGenome:
    codes: np.ndarray       # uint8 [G] 0..3, 4 for N
    names: list[str]        # contig names in genome order
    offsets: np.ndarray     # int64 [C] start of each contig in `codes`
    lengths: np.ndarray     # int64 [C]

    @property
    def ends(self) -> np.ndarray:
        return self.offsets + self.lengths


@dataclasses.dataclass
class SimLibrary:
    """Read pairs as sequenced, with the truth of each end (index 0 is
    read 1, index 1 read 2)."""
    bases: np.ndarray       # uint8 [2, N, L] as sequenced
    quals: np.ndarray       # uint8 [2, N, L] phred
    start: np.ndarray       # int64 [2, N] leftmost genome base of the source
    reverse: np.ndarray     # bool [2, N] the read is the reverse complement
    indel: np.ndarray       # int64 [2, N] +k insertion, -k deletion, 0 none
    indel_at: np.ndarray    # int64 [2, N] forward-read index of the indel
    damaged: np.ndarray     # bool [N] read 2 carries a substitution every 10th base
    far: np.ndarray         # bool [N] read 2 drawn >= far_min bases away
    dup_of: np.ndarray      # int64 [N] template copied, -1 for an original

    @property
    def pairs(self) -> int:
        return int(self.bases.shape[1])

    @property
    def read_len(self) -> int:
        return int(self.bases.shape[2])


def revcomp(reads: np.ndarray) -> np.ndarray:
    rc = reads[..., ::-1]
    return np.where(rc < 4, 3 - rc, rc).astype(np.uint8)


def _paste_family(rng, codes, elem_len: int, copies: int, div: tuple) -> None:
    """`copies` copies of one random element of `elem_len`, each with its
    own divergence drawn from the range `div`, at random positions."""
    g = codes.shape[0]
    elem = rng.integers(0, 4, elem_len).astype(np.uint8)
    for _ in range(copies):
        pos = int(rng.integers(0, g - elem_len))
        d = float(rng.uniform(div[0], div[1]))
        mut = rng.random(elem_len) < d
        codes[pos : pos + elem_len] = np.where(
            mut, rng.integers(0, 4, elem_len), elem)


def _copies(spec: dict, genome_len: int, elem_len: float) -> int:
    if "copies" in spec:
        return int(spec["copies"])
    return int(round(spec["share"] * genome_len / elem_len))


def make_genome(spec: dict) -> SimGenome:
    """The genome of a configuration's `genome` block, drawn from its own
    `seed`: random bases, each family pasted (elements of one length, or
    fragments of a range of lengths cut from one element), segmental
    duplications copied within the genome, then an N block centred in
    each contig."""
    rng = np.random.default_rng(int(spec["seed"]))
    lengths = np.array([c["length"] for c in spec["contigs"]], np.int64)
    names = [c["name"] for c in spec["contigs"]]
    g = int(lengths.sum())
    codes = rng.integers(0, 4, g).astype(np.uint8)
    for fam in spec.get("families", []):
        div = tuple(fam["divergence"])
        lo, hi = fam["length"] if isinstance(fam["length"], list) \
            else (fam["length"], fam["length"])
        if lo == hi:
            _paste_family(rng, codes, int(lo), _copies(fam, g, lo), div)
            continue
        # fragments of one full-length element (L1-like truncation)
        elem = rng.integers(0, 4, int(hi)).astype(np.uint8)
        for _ in range(_copies(fam, g, (lo + hi) / 2)):
            n = int(rng.integers(lo, hi + 1))
            src = elem[hi - n:]
            pos = int(rng.integers(0, g - n))
            mut = rng.random(n) < float(rng.uniform(div[0], div[1]))
            codes[pos : pos + n] = np.where(mut, rng.integers(0, 4, n), src)
    sd = spec.get("segdups")
    if sd:
        lo, hi = sd["length"]
        for _ in range(_copies(sd, g, (lo + hi) / 2)):
            n = int(rng.integers(lo, hi + 1))
            src = int(rng.integers(0, g - n))
            dst = int(rng.integers(0, g - n))
            mut = rng.random(n) < float(rng.uniform(*sd["divergence"]))
            codes[dst : dst + n] = np.where(mut, rng.integers(0, 4, n),
                                            codes[src : src + n])
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    n_frac = float(spec.get("n_block_fraction", 0.0))
    for off, ln in zip(offsets, lengths):
        n = int(ln * n_frac)
        if n:
            a = int(off + (ln - n) // 2)
            codes[a : a + n] = 4
    return SimGenome(codes=codes, names=names, offsets=offsets,
                     lengths=lengths)


def _reads_at(rng, codes, starts, read_len: int, mutate: float,
              indel_frac: float, max_indel: int, margin: int):
    """Forward-strand reads at `starts`: an indel_frac share carries one
    1..max_indel bp insertion or deletion at least `margin` bases from
    either end, then `mutate` substitutions.  Returns (reads, indel,
    indel_at)."""
    n = starts.shape[0]
    reads = codes[starts[:, None] + np.arange(read_len)[None, :]].copy()
    indel = np.zeros(n, np.int64)
    indel_at = np.zeros(n, np.int64)
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
        indel_at[i] = j
    mut = rng.random(reads.shape) < mutate
    reads = np.where(mut, rng.integers(0, 4, reads.shape), reads).astype(np.uint8)
    return reads, indel, indel_at


def binned_quals(rng, n: int, read_len: int, q: dict) -> np.ndarray:
    """Qualities in the binned `levels`, best first: at position t of a
    read, the best level has probability `best[0]` at the 5' end falling
    linearly to `best[1]` at the 3' end, and the rest of the mass goes to
    the lower levels in the ratio `rest`."""
    levels = np.asarray(q["levels"], np.uint8)
    frac = np.linspace(0.0, 1.0, read_len)
    p_best = q["best"][0] + (q["best"][1] - q["best"][0]) * frac
    rest = np.asarray(q["rest"], np.float64)
    rest = rest / rest.sum()
    cdf = np.concatenate([p_best[:, None],
                          p_best[:, None] + np.cumsum(
                              (1 - p_best)[:, None] * rest[None, :], axis=1)],
                         axis=1)                     # [L, levels]
    u = rng.random((n, read_len))
    idx = (u[:, :, None] > cdf[None, :, :]).sum(axis=2)
    return levels[np.minimum(idx, len(levels) - 1)]


def _starts_within(rng, genome: SimGenome, n: int, span: int) -> np.ndarray:
    """`n` genome positions drawn uniformly among those where `span`
    bases fit inside one contig (a fragment comes from one molecule)."""
    room = np.maximum(genome.lengths - span, 0)
    u = rng.integers(0, int(room.sum()), n)
    c = np.searchsorted(np.cumsum(room), u, side="right")
    return genome.offsets[c] + u - (np.cumsum(room) - room)[c]


def make_library(genome: SimGenome, lib: dict, pairs: int,
                 seed: int) -> SimLibrary:
    """`pairs` read pairs from `genome` by the `library` block of a traffic
    mix, drawn from `seed` (the frozen `make_pairs` recipe): fragment
    lengths from N(insert) clipped to insert_range, half the fragments on
    each strand (FRp or RFm), substitutions and indels per end, a damaged
    share of read 2s with a substitution every 10th base (placed only by
    the shadow rescue), a far share of read 2s drawn >= far_min bases away
    (disjoined pairs), then a dup share of templates replaced by copies of
    earlier originals (bases and qualities).  Every fragment, and every
    far mate, lies inside one contig."""
    rng = np.random.default_rng(seed)
    codes = genome.codes
    n = int(pairs)
    read_len = int(lib["read_len"])
    max_indel = int(lib["max_indel"])
    lo_ins, hi_ins = lib["insert_range"]
    frag = np.clip(np.rint(rng.normal(lib["insert"][0], lib["insert"][1], n)),
                   lo_ins, hi_ins).astype(np.int64)
    p = _starts_within(rng, genome, n, hi_ins + max_indel)
    fwd = rng.random(n) < 0.5
    lo, hi = p, p + frag - read_len
    start1 = np.where(fwd, lo, hi)
    start2 = np.where(fwd, hi, lo)
    far_min = int(lib["far_min"])
    far = rng.random(n) < lib["far_frac"]
    for i in np.nonzero(far)[0]:
        q = start1[i]
        while abs(q - start1[i]) < far_min:
            q = int(_starts_within(rng, genome, 1, read_len + max_indel)[0])
        start2[i] = q
    args = (read_len, lib["mutate"], lib["indel_frac"], max_indel,
            int(lib["margin"]))
    r1, ind1, at1 = _reads_at(rng, codes, start1, *args)
    r2, ind2, at2 = _reads_at(rng, codes, start2, *args)
    r1 = np.where(fwd[:, None], r1, revcomp(r1))
    r2 = np.where(fwd[:, None], revcomp(r2), r2)
    damaged = (rng.random(n) < lib["damaged_frac"]) & ~far
    cols = np.arange(0, read_len, 10)
    sub = r2[damaged][:, cols]
    shifted = (sub + rng.integers(1, 4, sub.shape)) % 4
    r2[np.ix_(np.nonzero(damaged)[0], cols)] = np.where(sub < 4, shifted, sub)
    quals = binned_quals(rng, 2 * n, read_len, lib["quals"]).reshape(
        2, n, read_len)
    out = SimLibrary(
        bases=np.stack([r1, r2]).astype(np.uint8), quals=quals,
        start=np.stack([start1, start2]).astype(np.int64),
        reverse=np.stack([~fwd, fwd.copy()]),
        indel=np.stack([ind1, ind2]), indel_at=np.stack([at1, at2]),
        damaged=damaged, far=far, dup_of=np.full(n, -1, np.int64))
    # duplicate fragments: a dup share of templates become copies of
    # earlier originals (PCR duplicates read twice, byte for byte)
    dups = np.nonzero(rng.random(n) < lib["dup_frac"])[0]
    for i in dups[dups > 0]:
        s = int(rng.integers(0, i))
        if out.dup_of[s] >= 0:
            s = int(out.dup_of[s])
        out.dup_of[i] = s
        for arr in (out.bases, out.quals, out.start, out.reverse, out.indel,
                    out.indel_at):
            arr[:, i] = arr[:, s]
        out.damaged[i] = out.damaged[s]
        out.far[i] = out.far[s]
    return out


def fastq_bytes(bases: np.ndarray, quals: np.ndarray, prefix: str = "t",
                phred_offset: int = 33) -> bytes:
    """FASTQ records @<prefix><i> of one end, in one buffer."""
    n, l = bases.shape
    seq = ACGTN[bases]
    qual = (quals + phred_offset).astype(np.uint8)
    names = [f"@{prefix}{i}\n".encode() for i in range(n)]
    body = np.empty((n, 2 * l + 4), np.uint8)
    body[:, :l] = seq
    body[:, l] = ord("\n")
    body[:, l + 1] = ord("+")
    body[:, l + 2] = ord("\n")
    body[:, l + 3 : 2 * l + 3] = qual
    body[:, 2 * l + 3] = ord("\n")
    rows = body.tobytes()
    w = 2 * l + 4
    return b"".join(nm + rows[i * w:(i + 1) * w] for i, nm in enumerate(names))


def write_fastq_gz(path: Path, bases: np.ndarray, quals: np.ndarray,
                   level: int = 1) -> None:
    with gzip.open(path, "wb", compresslevel=level) as f:
        f.write(fastq_bytes(bases, quals))
