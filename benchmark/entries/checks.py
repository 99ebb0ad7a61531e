"""The numbers that decide `correct`, tallied over the rows an entry kept:
per end the judge's placement and NM, the reference's mapping quality,
and per pair the reference's proper-pair flag.

Exact counts (limit 0): `missing`, `nm_wrong`, `mapq_wrong`,
`proper_wrong`; graded: `misplaced_pct`, the share of placeable ends
(indel ends included) that are unaligned or hold more edits over their
aligned bases than the truth does there, and `log_prob_gap`, the largest
distance (in nats) between the program's log-probability of an end's
chosen ungapped alignment and the reference's.
"""

from __future__ import annotations

import collections

import numpy as np

from reference import mapq
from reference.judge import parse_cigar, truth_of

EXACT = ("missing", "nm_wrong", "mapq_wrong", "proper_wrong")


class Tally:
    def __init__(self):
        self.counts = collections.Counter({k: 0 for k in EXACT})
        self.gap = 0.0

    def add(self, other: "Tally") -> None:
        self.counts.update(other.counts)
        self.gap = max(self.gap, other.gap)

    def bad(self) -> bool:
        return any(self.counts[k] for k in EXACT)

    def numbers(self) -> dict:
        c = self.counts
        out = {k: int(c[k]) for k in EXACT}
        out["misplaced_pct"] = 100.0 * c["misplaced"] / max(c["placeable"], 1)
        out["log_prob_gap"] = float(self.gap)
        out["_mapq_ends"] = int(c["mapq_ends"])
        out["_proper_pairs"] = int(c["proper_pairs"])
        return out


def same_answers(a: dict, b: dict) -> bool:
    """Whether two kept units hold the same answers."""
    if a.keys() != b.keys():
        return False
    for key, va in a.items():
        vb = b[key]
        if key == "cands":
            if va.keys() != vb.keys() or not all(
                    all(np.array_equal(x, y) for x, y in zip(
                        (va[g][0], *va[g][1].values()),
                        (vb[g][0], *vb[g][1].values()))) for g in va):
                return False
        elif isinstance(va, np.ndarray):
            if not np.array_equal(va, vb):
                return False
        elif va != vb:
            return False
    return True


def ref_span(cigar, read_len: int) -> int:
    if not cigar:
        return read_len
    return sum(n for n, op in parse_cigar(cigar) if op in "MDN=X")


class Pairs:
    """Judges rows of read pairs: each end against the planted truth and
    the genome (`judge`), its mapping quality against the reference's
    from the candidates the program held, and the pair's proper flag
    against the pair model."""

    def __init__(self, ctx, judge):
        self.ctx, self.judge = ctx, judge
        g = ctx.genome
        self.codes, self.offsets, self.ends = g.codes, g.offsets, g.ends
        self.group_offset = {n: int(o) for n, o in zip(g.names, g.offsets)}
        self.genome_length = int(g.lengths.sum())
        self.cap = int(ctx.config["workflow"]["mapq_cap"])
        mu, sd = ctx.traffic["library"]["insert"]
        #: template lengths that every model learned from the library
        #: holds (the model spans the 0.135%-99.865% quantiles)
        self.nominal = (mu - 2 * sd, mu + 2 * sd)
        self.far = int(ctx.traffic["library"]["far_min"]) // 10

    @staticmethod
    def by_template(cands: dict) -> dict:
        """{template: [(group, rows, i)]} of a `program.candidates_kept`
        store ({(group, first): (ids, rows)})."""
        out: dict = {}
        for (group, _first), (ids, rows) in cands.items():
            for i, t in enumerate(ids.tolist()):
                out.setdefault(t, []).append((group, rows, i))
        return out

    def candidates(self, held: list, sfx: str, read_len: int):
        """(starts, reverse, valid) of one end over every contig group, in
        genome coordinates, from its entries of `by_template`; None when a
        group's pick of the end is not one of its candidates, ungapped
        (a host pass, the gapped polish or the rescue, placed it there, and
        the merge weighs that placement)."""
        parts = []
        for group, rows, i in held:
            start = rows["cand_start" + sfx][i].astype(np.int64)
            rev = rows["cand_orient" + sfx][i] == 1
            valid = rows["cand_valid" + sfx][i].astype(bool)
            if bool(rows["aligned" + sfx][i]):
                cig = rows["cigar" + sfx][i]
                hit = valid & (start == int(rows["start" + sfx][i])) & (
                    rev == bool(rows["reverse" + sfx][i]))
                if cig not in (None, "", f"{read_len}M") or not hit.any():
                    return None
            parts.append((start + self.group_offset[group], rev, valid))
        return tuple(np.concatenate(x) for x in zip(*parts))

    def handed_on_log_prob(self, held: list, sfx: str, start: int,
                           reverse: bool) -> float:
        """The log-probability the aligner handed on with an end's chosen
        alignment, where that alignment is `start`/`reverse` (NaN
        otherwise)."""
        for group, rows, i in held:
            if (int(rows["start" + sfx][i]) + self.group_offset[group]
                    == start and bool(rows["reverse" + sfx][i]) == reverse):
                return float(rows["log_prob" + sfx][i])
        return float("nan")

    def rows(self, tally: Tally, templates: np.ndarray, ends: list[dict],
             proper: np.ndarray, held: dict) -> None:
        """Judge rows j of `ends` (per end: aligned, start, reverse,
        edit_distance, frag_score, log_prob arrays and a cigar list; start
        in genome coordinates; log_prob NaN where the program gave none)
        whose templates are `templates`, with the candidates `held`
        (`by_template`)."""
        lib, judge = self.ctx.library, self.judge
        c = tally.counts
        place = judge.placeable(lib, templates)
        l = lib.read_len
        for j, t in enumerate(np.asarray(templates).tolist()):
            right = []
            for e, end in enumerate(ends):
                aligned = bool(end["aligned"][j])
                seq = lib.bases[e, t]
                cigar = end["cigar"][j]
                start = int(end["start"][j])
                reverse = bool(end["reverse"][j])
                place_e, bad, nm_bad = judge.end(
                    seq, truth_of(lib, e, t), bool(place[e, j]), aligned,
                    start, reverse, cigar, int(end["edit_distance"][j]))
                c["placeable"] += int(place_e)
                c["misplaced"] += int(bad)
                c["nm_wrong"] += int(nm_bad)
                right.append(aligned and place_e and not bad)
                if not aligned or t not in held:
                    continue
                cand = self.candidates(held[t], "_1" if e == 0 else "_2", l)
                if cand is None:
                    continue
                lp = float(end["log_prob"][j])
                got = mapq.end_mapq_check(
                    self.codes, self.offsets, self.ends, self.genome_length,
                    seq, lib.quals[e, t], cand, start, reverse, cigar,
                    int(end["frag_score"][j]), None if lp != lp else lp,
                    self.cap)
                if got is not None:
                    c["mapq_ends"] += 1
                    c["mapq_wrong"] += got[0]
                    tally.gap = max(tally.gap, got[1])
            if not all(right):
                continue
            a, b = ends
            pa, pb = int(a["start"][j]), int(b["start"][j])
            expect = mapq.proper_expected(
                judge.contig_of(pa) == judge.contig_of(pb),
                bool(a["reverse"][j]), pa, ref_span(a["cigar"][j], l),
                bool(b["reverse"][j]), pb, ref_span(b["cigar"][j], l),
                self.nominal, self.far)
            if expect is not None:
                c["proper_pairs"] += 1
                c["proper_wrong"] += int(bool(proper[j]) != expect)
