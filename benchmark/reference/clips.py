"""Plain reference of `isaac-align`'s default clipping passes on one read
pair (numpy only; nothing of the program is imported).

From each end's placement before clipping (the genome position of its
first aligned base, its strand and a CIGAR of M, I and D over the whole
read) and the pair's template-length model, `clip_pair` works out what the
defaults (`--base-quality-cutoff 25`, `--clip-semialigned 1`,
`--clip-overlapping 1`) make of the pair:

1. the 3' quality trim (iSAAC `trimLowQualityEnd`): walking from the
   read's last base toward its 5' end, sum cutoff - quality and stop
   before the sum goes negative; the bases through the first position of
   the largest positive sum are trimmed.  The walk never enters the first
   35 bases, so reads under 36 bases keep every base;
2. the trimmed bases soft-clipped: at the alignment's right end forward,
   its left end reverse; a gapped CIGAR loses the aligned run under the
   clip, and a gap left at the clip's edge goes with it;
3. a gapless alignment overhanging its contig (the one holding the
   read's middle base at the unclipped start) soft-clipped to the contig;
4. the semialigned clip (iSAAC `clipMismatches`, SemialignedEndsClipper):
   of a gapless alignment, each end is clipped back to its first run of 5
   consecutive matches inside what the clips above left aligned, where a
   read N matches and a genome N does not; the clip is made only when it
   leaves more than 5 bases past both runs;
5. the overlap clip of a forward-reverse pair (OverlappingEndsClipper):
   both ends gapless, the leftmost aligned end (read 1 on equal starts)
   forward, the two aligned spans overlapping by less than either; each
   end's bases aligned inside the overlap (its 3' tail there) sum their
   qualities, and the lower sum loses the overlap, the right end on a tie:
   a forward loser grows its right soft clip, a reverse loser its left one;
6. POS (the first aligned base), the CIGAR string and NM (mismatches,
   counting any read or genome N, plus inserted and deleted bases) of
   what each end keeps aligned;
7. the proper flag from the unclipped placements by the pair model: both
   ends on one contig, their model (which end is leftmost, and the two
   strands) one of the model's two best, and the template length (from
   the leftmost start to the rightmost start plus a read length, the
   longer end's read length when one holds the other) inside [min, max];
   and TLEN from the final placements: from the leftmost aligned base to
   the rightmost, positive on the end whose POS is lower (read 1 on equal
   POS), 0 unless both ends are aligned on one contig.

Departures from iSAAC: gapped alignments keep their ends in step 4, as
the program's gapped polish keeps its realigned ends; step 5 clips gapless
pairs only and compares summed qualities over the aligned overlap; the
contig clip of step 3 and the trim of a reverse read on the same side
take the larger of the two, not their sum; the pair model of step 7 sees
each end as a read length long, as the program's pair step does.
"""

from __future__ import annotations

import re

import numpy as np

N = 4
CUTOFF = 25
#: the quality trim's walk never enters a read's first 35 bases
TRIM_KEEP = 35
#: consecutive matches that end the semialigned clip
RUN = 5

_OP = re.compile(r"(\d+)([MIDS])")


def parse(cigar: str | None, read_len: int) -> list[tuple[int, str]]:
    if not cigar:
        return [(read_len, "M")]
    return [(int(n), op) for n, op in _OP.findall(cigar)]


def text(ops) -> str:
    return "".join(f"{n}{op}" for n, op in ops)


def revcomp(codes: np.ndarray) -> np.ndarray:
    out = np.empty_like(codes)
    for j in range(codes.shape[0]):
        c = int(codes[codes.shape[0] - 1 - j])
        out[j] = 3 - c if c < 4 else c
    return out


def unclipped(start: int, cigar: str | None, read_len: int):
    """The placement before clipping of a reported alignment: its soft
    clips aligned as matches in line with the aligned run beside them.
    Returns (start, ops of M, I and D over the whole read)."""
    ops = parse(cigar, read_len)
    if ops and ops[0][1] == "S":
        start -= ops[0][0]
    out: list[tuple[int, str]] = []
    for n, op in ops:
        op = "M" if op == "S" else op
        if out and out[-1][1] == op:
            out[-1] = (out[-1][0] + n, op)
        else:
            out.append((n, op))
    return int(start), out


def trim_low_quality_end(quals: np.ndarray, cutoff: int = CUTOFF) -> int:
    """Bases trimmed from the 3' end (step 1)."""
    if cutoff <= 0:
        return 0
    total, best, trim = 0, 0, 0
    walked = 0
    for j in range(quals.shape[0] - 1, TRIM_KEEP - 1, -1):
        total += cutoff - int(quals[j])
        walked += 1
        if total < 0:
            break
        if total > best:
            best, trim = total, walked
    return trim


def clip_query(ops, n: int, at_end: bool):
    """Soft-clip `n` query bases from the end (or the start) of an M/I/D
    CIGAR (step 2).  Returns (ops, reference bases taken from that side)."""
    run = [list(o) for o in (reversed(ops) if at_end else ops)]
    left, ref = n, 0
    while left > 0 and run:
        length, op = run[0]
        if op == "D":
            ref += length
            run.pop(0)
            continue
        take = min(length, left)
        left -= take
        if op == "M":
            ref += take
        if take == length:
            run.pop(0)
        else:
            run[0][0] = length - take
    while run and run[0][1] in "ID":
        length, op = run.pop(0)
        if op == "I":
            n += length
        else:
            ref += length
    out = ([(n, "S")] if n else []) + [tuple(o) for o in run]
    return (out[::-1] if at_end else out), ref


def _matches(codes: np.ndarray, seq: np.ndarray, start: int) -> np.ndarray:
    """Per oriented read column, whether it matches the genome at `start`
    (a read N matches, a genome N does not)."""
    out = np.zeros(seq.shape[0], bool)
    for j in range(seq.shape[0]):
        g = start + j
        r = int(codes[g]) if 0 <= g < codes.shape[0] else N
        s = int(seq[j])
        out[j] = s == N or (s == r and r != N)
    return out


def semialigned(match: np.ndarray, lead: int, tail: int) -> tuple[int, int]:
    """(left, right) clips of step 4 over columns [lead, len - tail)."""
    l = match.shape[0]
    core = l - lead - tail

    def first_run(cols) -> int:
        seen = 0
        for k, j in enumerate(cols):
            seen = seen + 1 if match[j] else 0
            if seen == RUN:
                return k - RUN + 1
        return 0

    left = first_run(range(lead, l - tail))
    right = first_run(range(l - tail - 1, lead - 1, -1))
    if (left or right) and left + right + RUN < core:
        return left, right
    return 0, 0


def edits(codes: np.ndarray, seq: np.ndarray, start: int, ops) -> int:
    """NM of an alignment (step 6): `start` is the first aligned base."""
    nm, r, g = 0, 0, start
    for n, op in ops:
        if op == "S":
            r += n
        elif op == "M":
            for _ in range(n):
                s, ref = int(seq[r]), int(codes[g])
                nm += int(s != ref or s == N or ref == N)
                r += 1
                g += 1
        elif op == "I":
            nm += n
            r += n
        elif op == "D":
            nm += n
            g += n
    return nm


def ref_span(ops) -> int:
    return sum(n for n, op in ops if op in "MD")


def contig_of(contig_starts, pos: int) -> int:
    c = 0
    for k, s in enumerate(contig_starts):
        if s <= pos:
            c = k
    return c


def template_length(p1: int, l1: int, p2: int, l2: int) -> int:
    if p1 < p2:
        return max(p2 + l2 - p1, l1)
    return max(p1 + l1 - p2, l2)


def model(p1: int, r1: bool, p2: int, r2: bool) -> int:
    return (0 if p1 <= p2 else 4) | (int(r1) << 1) | int(r2)


def clip_pair(codes: np.ndarray, contig_starts, contig_ends, ends: list,
              tls: dict, cutoff: int = CUTOFF, semialigned_clip: bool = True,
              overlapping: bool = True):
    """Steps 1-7 on one pair.  `ends` holds two dicts: `aligned`, `start`,
    `reverse`, `ops` (the placement before clipping), `bases` and `quals`
    as sequenced.  `tls` holds `min`, `max` and `best` (the two best
    models).  Returns ([per end: pos, cigar, nm, trimmed, semialigned,
    overlap] or None when unaligned, {proper, tlen: [end 1, end 2]})."""
    work = []
    for e in ends:
        if not e["aligned"]:
            work.append(None)
            continue
        l = e["bases"].shape[0]
        seq = revcomp(e["bases"]) if e["reverse"] else e["bases"].copy()
        t = trim_low_quality_end(e["quals"], cutoff)
        start = int(e["start"])
        ops = list(e["ops"])
        gapped = any(op in "ID" for _n, op in ops)
        w = {"trimmed": t > 0, "semialigned": False, "overlap": False,
             "reverse": bool(e["reverse"]), "seq": seq,
             "quals": e["quals"], "len": l, "gapped": gapped,
             "unclipped": start}
        if gapped:
            if t:
                ops, taken = clip_query(ops, t, at_end=not e["reverse"])
                if e["reverse"]:
                    start += taken
            w.update(pos=start, ops=ops)
        else:
            c = contig_of(contig_starts, start + l // 2)
            lead = max(int(contig_starts[c]) - start, 0)
            tail = max(start + l - int(contig_ends[c]), 0)
            if e["reverse"]:
                lead = max(lead, t)
            else:
                tail = max(tail, t)
            if semialigned_clip:
                left, right = semialigned(_matches(codes, seq, start),
                                          lead, tail)
                w["semialigned"] = bool(left or right)
                lead, tail = lead + left, tail + right
            w.update(lead=lead, tail=tail, origin=start)
        work.append(w)

    a, b = work
    if overlapping and a is not None and b is not None \
            and not a["gapped"] and not b["gapped"] \
            and a["reverse"] != b["reverse"]:
        spans = []
        for w in (a, b):
            m = w["len"] - w["lead"] - w["tail"]
            spans.append((w["origin"] + w["lead"], m))
        first = 0 if spans[0][0] <= spans[1][0] else 1
        lw, rw = work[first], work[1 - first]
        (lpos, lm), (rpos, rm) = spans[first], spans[1 - first]
        over = lpos + lm - rpos
        if not lw["reverse"] and 0 < over < lm and over < rm:
            def tail_quality(w, at_right: bool) -> int:
                l = w["len"]
                if at_right:      # forward: last `over` aligned columns
                    cols = range(w["lead"] + (l - w["lead"] - w["tail"])
                                 - over, l - w["tail"])
                else:             # reverse: first `over` aligned columns
                    cols = range(w["lead"], w["lead"] + over)
                total = 0
                for j in cols:
                    sequenced = l - 1 - j if w["reverse"] else j
                    total += int(w["quals"][sequenced])
                return total
            if tail_quality(lw, True) >= tail_quality(rw, False):
                rw["lead"] += over
                rw["overlap"] = True
            else:
                lw["tail"] += over
                lw["overlap"] = True

    out = []
    for w in work:
        if w is None:
            out.append(None)
            continue
        if not w["gapped"]:
            l = w["len"]
            body = l - w["lead"] - w["tail"]
            ops = ([(w["lead"], "S")] if w["lead"] else []) + [(body, "M")] \
                + ([(w["tail"], "S")] if w["tail"] else [])
            w.update(pos=w["origin"] + w["lead"], ops=ops)
        out.append({"pos": int(w["pos"]), "cigar": text(w["ops"]),
                    "nm": edits(codes, w["seq"], w["pos"], w["ops"]),
                    "trimmed": w["trimmed"],
                    "semialigned": w["semialigned"],
                    "overlap": w["overlap"]})

    pair = {"proper": False, "tlen": [0, 0]}
    if a is not None and b is not None:
        p1, p2 = a["unclipped"], b["unclipped"]
        same = contig_of(contig_starts, p1) == contig_of(contig_starts, p2)
        length = template_length(p1, a["len"], p2, b["len"])
        pair["proper"] = bool(
            same and model(p1, a["reverse"], p2, b["reverse"]) in tls["best"]
            and tls["min"] <= length <= tls["max"])
        q1, q2 = out[0]["pos"], out[1]["pos"]
        if contig_of(contig_starts, q1) == contig_of(contig_starts, q2):
            right = max(q1 + ref_span(a["ops"]), q2 + ref_span(b["ops"]))
            span = right - min(q1, q2)
            pair["tlen"] = [span, -span] if q1 <= q2 else [-span, span]
    return out, pair
