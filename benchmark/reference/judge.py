"""The plain reference that decides `correct`: each sampled read end is
judged against its planted truth and the genome (numpy only; nothing of
the program is imported or read, but the alignment it reports).

For each end the judge works out again:
- whether the truth is placeable by the configuration's seeds: its source
  window lies inside one contig and holds no N, and one of the read's
  32-mers at the seed offsets (0, 32, 64, 96 and flush with the 3' end)
  is the genome's there, free of errors, and occurs no more than the
  repeat threshold's times in the genome on either strand
  (`SeedCounts`); a damaged read 2, which no seed can place, is
  placeable when its read 1 is (the shadow rescue's guarantee);
- the edit distance of the reported alignment from its CIGAR, its
  position and the genome (mismatches, N counting as one, plus inserted
  and deleted bases), which the reported NM has to equal exactly;
- whether the reported alignment holds no more edits over its aligned
  bases than the truth's alignment holds over the same bases: the truth
  itself, or an equally good repeat copy.

A placeable end that is neither, or is not aligned, is `misplaced`.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

_CIGAR = re.compile(r"(\d+)([MIDNSHP=X])")


def parse_cigar(cigar: str) -> list[tuple[int, str]]:
    return [(int(n), op) for n, op in _CIGAR.findall(cigar)]


def revcomp(codes: np.ndarray) -> np.ndarray:
    rc = codes[::-1]
    return np.where(rc < 4, 3 - rc, rc).astype(np.uint8)


def truth_map(read_len: int, start: int, indel: int, at: int) -> np.ndarray:
    """Genome position of each forward-read base at the truth, -1 for an
    inserted base."""
    r = np.arange(read_len, dtype=np.int64)
    g = start + r
    if indel < 0:
        g = np.where(r >= at, g - indel, g)
    elif indel > 0:
        g = np.where(r >= at + indel, g - indel,
                     np.where(r >= at, -1, g))
    return g


def truth_map_many(read_len: int, start, indel, at) -> np.ndarray:
    """`truth_map` of many reads: [m, read_len]."""
    r = np.arange(read_len, dtype=np.int64)[None, :]
    start, indel, at = (np.asarray(x, np.int64)[:, None]
                        for x in (start, indel, at))
    g = start + r
    g = np.where((indel < 0) & (r >= at), g - indel, g)
    ins = indel > 0
    g = np.where(ins & (r >= at + indel), g - indel,
                 np.where(ins & (r >= at), -1, g))
    return g


def kmer_codes(codes: np.ndarray, k: int) -> np.ndarray:
    """uint64 code of every k-mer of `codes` (k <= 32); windows holding
    an N get the all-ones code."""
    n = codes.shape[0] - k + 1
    acc = np.zeros(n, np.uint64)
    bad = np.zeros(n, bool)
    for j in range(k):
        c = codes[j:j + n]
        acc = (acc << np.uint64(2)) | (c & 3).astype(np.uint64)
        bad |= c == 4
    acc[bad] = np.uint64(2**64 - 1)
    return acc


def revcomp_codes(kmers: np.ndarray, k: int) -> np.ndarray:
    """Codes of the reverse complements of k-mer codes."""
    out = np.zeros_like(kmers)
    x = kmers.copy()
    for _ in range(k):
        out = (out << np.uint64(2)) | (np.uint64(3) - (x & np.uint64(3)))
        x >>= np.uint64(2)
    return out


class SeedCounts:
    """Occurrences of each k-mer in a genome, both strands, from a sorted
    array of canonical codes (the smaller of a k-mer's and its reverse
    complement's), kept in `cache` (a .npy path) when one is given."""

    def __init__(self, codes: np.ndarray, k: int = 32, cache=None):
        self.k = k
        if cache is not None and Path(cache).is_file():
            self.sorted = np.load(cache)
            return
        fwd = kmer_codes(codes, k)
        ok = fwd != np.uint64(2**64 - 1)
        fwd = fwd[ok]
        self.sorted = np.sort(np.minimum(fwd, revcomp_codes(fwd, k)))
        if cache is not None:
            tmp = Path(str(cache) + ".tmp.npy")
            np.save(tmp, self.sorted)
            tmp.replace(cache)

    def count(self, kmers: np.ndarray) -> np.ndarray:
        canon = np.minimum(kmers, revcomp_codes(kmers, self.k))
        return (np.searchsorted(self.sorted, canon, side="right")
                - np.searchsorted(self.sorted, canon, side="left"))


def seed_offsets(read_len: int, k: int) -> list[int]:
    """Seeds tiling the read, plus one flush with its end."""
    offs = list(range(0, read_len - k + 1, k))
    if read_len - k > offs[-1]:
        offs.append(read_len - k)
    return offs


class Judge:
    """Judges ends against one genome (`codes`, contig `offsets` and
    `ends` in genome order) with the configuration's seed length and
    repeat threshold."""

    def __init__(self, codes: np.ndarray, offsets, ends, seed_len: int,
                 repeat_threshold: int, cache=None):
        self.codes = codes
        self.offsets = np.asarray(offsets, np.int64)
        self.ends = np.asarray(ends, np.int64)
        self.seed_len = int(seed_len)
        self.repeat_threshold = int(repeat_threshold)
        self.counts = SeedCounts(codes, self.seed_len, cache)
        self.n_before = np.concatenate(
            [[0], np.cumsum(codes == 4, dtype=np.int64)])

    def contig_of(self, pos: int) -> int:
        return int(np.searchsorted(self.offsets, pos, side="right")) - 1

    def in_contig(self, start: np.ndarray, span: np.ndarray) -> np.ndarray:
        """Windows [start, start + span) inside one contig and free of N."""
        start = np.asarray(start, np.int64)
        end = start + np.asarray(span, np.int64)
        c = np.searchsorted(self.offsets, start, side="right") - 1
        ok = (c >= 0) & (end <= self.ends[np.maximum(c, 0)])
        end = np.minimum(end, self.codes.shape[0])
        return ok & (self.n_before[end] == self.n_before[start])

    def seedable(self, seqs: np.ndarray, truth: tuple) -> np.ndarray:
        """Whether each read (rows of `seqs`, as sequenced) is placeable
        at its truth (`truth` = arrays of start, reverse, indel,
        indel_at) by an error-free seed of at most `repeat_threshold`
        occurrences."""
        start, reverse, indel, at = (np.asarray(x) for x in truth)
        m, l = seqs.shape
        k = self.seed_len
        rc = seqs[:, ::-1]
        fwd = np.where(reverse[:, None], np.where(rc < 4, 3 - rc, rc), seqs)
        gmap = truth_map_many(l, start, indel, at)
        ok = np.zeros(m, bool)
        cols = np.arange(k)
        for off in seed_offsets(l, k):
            f0 = np.where(reverse, l - off - k, off)
            idx = f0[:, None] + cols[None, :]
            g = np.take_along_axis(gmap, idx, axis=1)
            q = np.take_along_axis(fwd, idx, axis=1)
            clean = (g >= 0).all(axis=1) & (g[:, -1] - g[:, 0] == k - 1)
            clean &= (q == self.codes[np.maximum(g, 0)]).all(axis=1)
            code = np.zeros(m, np.uint64)
            for j in range(k):
                code = (code << np.uint64(2)) | (q[:, j] & 3).astype(np.uint64)
            ok |= clean & (self.counts.count(code) <= self.repeat_threshold)
        return ok & self.in_contig(start, l + np.maximum(0, -indel))

    def placeable(self, lib, templates: np.ndarray) -> np.ndarray:
        """[2, n] whether read 1 and read 2 of `templates` of a library
        are placeable; a damaged read 2 is when its read 1 is and its
        own window lies in one contig free of N."""
        t = np.asarray(templates, np.int64)
        l = lib.read_len
        out = np.stack([self.seedable(lib.bases[e, t], tuple(
            a[e, t] for a in (lib.start, lib.reverse, lib.indel,
                              lib.indel_at))) for e in (0, 1)])
        dam = lib.damaged[t]
        win2 = self.in_contig(lib.start[1, t],
                              l + np.maximum(0, -lib.indel[1, t]))
        out[1] = np.where(dam, out[0] & win2, out[1])
        return out

    def _walk(self, seq, start: int, reverse: bool, cigar):
        """(edit distance, sequenced indices of the read bases it covers
        (matched or inserted, not clipped), count of matched bases) of a
        reported alignment, or None when its CIGAR does not cover the read
        or leaves the contig it starts in."""
        l = seq.shape[0]
        fwd = revcomp(seq) if reverse else seq
        c = self.contig_of(start)
        if c < 0:
            return None
        r, g, nm = 0, start, 0
        idx, pos = [], []
        for n, op in cigar:
            if op in "M=X":
                if r + n > l or g + n > self.ends[c]:
                    return None
                q = fwd[r:r + n]
                ref = self.codes[g:g + n]
                nm += int(((q != ref) | (q == 4) | (ref == 4)).sum())
                idx.append(np.arange(r, r + n))
                pos.append(np.arange(g, g + n))
                r += n
                g += n
            elif op == "I":
                if r + n > l:
                    return None
                nm += n
                idx.append(np.arange(r, r + n))
                r += n
            elif op in "DN":
                nm += n
                g += n
            elif op == "S":
                r += n
        if r != l or not pos:
            return None
        f = np.concatenate(idx)
        seq_idx = l - 1 - f if reverse else f
        return nm, seq_idx, int(sum(len(p) for p in pos))

    def _truth_edits(self, seq, truth: tuple, seq_idx: np.ndarray) -> int:
        """Edits of the truth's alignment over the sequenced bases
        `seq_idx` (a run of the read): mismatches, inserted bases, and a
        deletion lying between two of them."""
        l = seq.shape[0]
        t_start, t_rev, indel, at = (int(truth[0]), bool(truth[1]),
                                     int(truth[2]), int(truth[3]))
        fwd = revcomp(seq) if t_rev else seq
        f = l - 1 - seq_idx if t_rev else seq_idx
        g = truth_map(l, t_start, indel, at)[f]
        ins = g < 0
        q = fwd[f[~ins]]
        ref = self.codes[g[~ins]]
        edits = int(((q != ref) | (q == 4) | (ref == 4)).sum()) + int(ins.sum())
        if indel < 0 and f.min() < at <= f.max():
            edits += -indel
        return edits

    def end(self, seq, truth: tuple, place: bool, aligned: bool, start: int,
            reverse: bool, cigar, nm) -> tuple[bool, bool, bool]:
        """(placeable, misplaced, nm_wrong) of one end.  `seq` as
        sequenced; `truth` = (start, reverse, indel, indel_at); `place`
        whether the truth is placeable; `cigar` a string or op list (None:
        the whole read matched); `nm` the reported edit distance.

        An aligned end is misplaced when its aligned bases hold more edits
        than the truth holds over the same bases (at the truth, a gap
        missed or misplaced; elsewhere, a worse place than an equal repeat
        copy), or fewer than a seed's length of them are aligned.  Soft
        clips cost nothing, as in the configuration's gap scoring, whose
        match score is 0."""
        l = seq.shape[0]
        if not aligned:
            return place, place, False
        ops = parse_cigar(cigar) if isinstance(cigar, str) else (
            cigar if cigar else [(l, "M")])
        got = self._walk(seq, int(start), bool(reverse), ops)
        if got is None:
            return place, place, True
        r_nm, seq_idx, matched = got
        nm_bad = r_nm != int(nm)
        if not place:
            return False, False, nm_bad
        if matched < self.seed_len:
            return True, True, nm_bad
        return True, r_nm > self._truth_edits(seq, truth, seq_idx), nm_bad

def truth_of(lib, e: int, t: int) -> tuple:
    """(start, reverse, indel, indel_at) of end `e` of template `t`."""
    return (lib.start[e, t], lib.reverse[e, t], lib.indel[e, t],
            lib.indel_at[e, t])


def make_judge(ctx) -> Judge:
    """The judge of a run's genome at its configuration's settings; its
    k-mer counts are kept beside the run's cached index, keyed alike."""
    wf = ctx.config["workflow"]
    cache = None
    if ctx.index_path is not None:
        cache = ctx.index_path.parent / (
            f"{ctx.index_path.name}.kmers{wf['seed_len']}.npy")
    return Judge(ctx.genome.codes, ctx.genome.offsets, ctx.genome.ends,
                 wf["seed_len"], wf["repeat_threshold"], cache)
