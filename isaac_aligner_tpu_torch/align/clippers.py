"""Read clipping on the host: adapter masking, quality-trim masks, masked
tails, contig ends, semialigned ends, overlapping pair ends.

The port's own copy of the parts of `isaac_aligner_tpu/align/clippers.py`
that the single-end and paired-end paths call.  They part from it where
the JAX package is at fault (ROADMAP section C): `clip_overlapping` works
from each end's current start and CIGAR, `apply_semialigned_device` takes
the rows whose alignment changed after the device clip (`skip_rows`),
which the caller clips on the host instead, and every clip recounts NM
over the bases it leaves aligned.  Reference analogs:
- FragmentSequencingAdapterClipper
  (lib/alignment/matchSelector/FragmentSequencingAdapterClipper.cpp):
  known adapter sequences found near the 3' end are masked.  This
  implementation masks a suffix whose prefix matches an adapter with at
  most one mismatch.
- SemialignedEndsClipper (lib/alignment/matchSelector/
  SemialignedEndsClipper.cpp): soft-clip aligned ends until
  CONSECUTIVE_MATCHES_MIN=5 consecutive matches; the device computes the
  clip (pipeline.semialigned_clip_device) and `apply_semialigned_device`
  writes it into the result dict; `clip_semialigned` is the host pass for
  rows rescued after the device clip ran.
- OverlappingEndsClipper (lib/alignment/matchSelector/
  OverlappingEndsClipper.cpp): for FR pairs whose gapless ends overlap,
  soft-clip the overlap from the end with the lower summed base quality.

Adapter masking runs before the device pipeline (masked bases become
N/q0, which the scorer treats as neutral matches and whose seeds
self-exclude); the post-alignment clippers rewrite CIGARs in the batch
result dict like the gapped polish stage.
"""

from __future__ import annotations

import numpy as np

from .. import dna
from ..io.bam import parse_cigar

CONSECUTIVE_MATCHES_MIN = 5
MASK_READ_LENGTH_MIN = 35


def adapter_trim_batch(bases: np.ndarray, quals: np.ndarray,
                       adapters: list[str], min_overlap: int = 8) -> np.ndarray:
    """Mask 3' adapter contamination in place; returns trim counts.

    A suffix is masked when it begins with >= min_overlap bases matching
    an adapter prefix with <= 1 mismatch, or when a shorter full suffix
    exactly matches an adapter prefix.
    """
    b, l = bases.shape
    trims = np.zeros(b, np.int32)
    if not adapters:
        return trims
    acodes = [dna.encode(a) for a in adapters]
    exact_min = 5   # shorter suffixes must match the adapter prefix exactly
    for i in range(b):
        read = bases[i]
        best = 0
        for a in acodes:
            for s in range(l - exact_min, -1, -1):
                n = min(l - s, len(a))
                mm = int((read[s : s + n] != a[:n]).sum())
                if (n >= min_overlap and mm <= 1) or \
                        (exact_min <= n < min_overlap and mm == 0):
                    best = max(best, l - s)
                    break
        if best:
            trims[i] = best
            bases[i, l - best :] = dna.N
            quals[i, l - best :] = 0
    return trims


def apply_masked_tail_cigar(res: dict, suffix: str, trims: np.ndarray,
                            read_len: int) -> np.ndarray:
    """Turn masked tails into soft-clips in the result dict.

    Forward alignments clip at the CIGAR end; reverse alignments carry the
    masked read-tail at the genome-left side, so the clip leads and the
    position advances by the trim (the candidate start referenced the full
    oriented read).  Also corrects NM for the masked (N-scored) bases.
    Returns per row the trim whose soft clip it wrote (0 elsewhere), the
    `masked` of `gapped.polish_gapped`.
    """
    s = suffix
    key = "cigar" + s
    n = trims.shape[0]
    if key not in res:
        res[key] = [None] * n
    written = np.zeros(n, np.int64)
    cigars = res[key]
    rows = np.nonzero((np.asarray(trims) > 0)
                      & np.asarray(res["aligned" + s]).astype(bool))[0]
    # gapped cigars already reflect the masked bases as N
    rows = rows[np.fromiter((cigars[i] is None for i in rows.tolist()), bool,
                            rows.size)]
    if rows.size == 0:
        return written
    t = np.asarray(trims)[rows].astype(np.int64)
    rev = np.asarray(res["reverse" + s])[rows].astype(bool)
    zero = np.zeros_like(t)
    _write_sm_cigars(cigars, rows, np.where(rev, t, zero), read_len - t,
                     np.where(rev, zero, t))
    res["start" + s][rows] += np.where(rev, t, zero).astype(
        res["start" + s].dtype)
    ed = res["edit_distance" + s]
    ed[rows] = np.maximum(0, ed[rows].astype(np.int64) - t)
    written[rows] = t
    return written


def clip_contig_ends(res: dict, suffix: str, genome, read_len: int) -> None:
    """Soft-clip alignments overhanging their contig's edges.

    Reference analog: AlignerBase::updateFragmentCigar clips positions
    outside the contig (lib/alignment/AlignerBase.cpp:121-231).  The
    device scorer already excluded overhanging positions from mismatch/
    edit counts and probability mass (pipeline._score_ungapped in_contig
    mask); this host pass writes the matching lead/tail S CIGAR and moves
    the start to the first in-contig base.
    """
    s = suffix
    aligned = np.asarray(res["aligned" + s]).astype(bool)
    if not aligned.any():
        return
    starts = np.asarray(res["start" + s]).astype(np.int64)
    offs = genome.contig_offsets
    ends = offs + np.array([c.length for c in genome.contigs], np.int64)
    mid = starts + read_len // 2
    cid = np.clip(np.searchsorted(offs, mid, side="right") - 1,
                  0, len(offs) - 1)
    lead = np.maximum(offs[cid] - starts, 0)
    tail = np.maximum(starts + read_len - ends[cid], 0)
    rows = np.nonzero(aligned & ((lead > 0) | (tail > 0)))[0]
    if rows.size == 0:
        return
    key = "cigar" + s
    if key not in res:
        res[key] = [None] * aligned.shape[0]
    for i in rows:
        if res[key][i] is not None:
            continue   # rows with masked-tail CIGARs keep them
        lo, hi = int(lead[i]), int(tail[i])
        body = read_len - lo - hi
        parts = ([f"{lo}S"] if lo else []) + [f"{body}M"] + \
            ([f"{hi}S"] if hi else [])
        res[key][i] = "".join(parts)
        res["start" + s][i] += lo


def _oriented_read(bases_row: np.ndarray, reverse: bool) -> np.ndarray:
    if reverse:
        return dna.revcomp(bases_row)
    return bases_row


def _first_run_start(ok: np.ndarray, k: int) -> np.ndarray:
    """Per row: start index of the first run of k consecutive Trues in
    `ok` (0 when none, matching the legacy scan's no-clip fallback)."""
    n, l = ok.shape
    idx = np.arange(l, dtype=np.int64)[None, :]
    last_false = np.maximum.accumulate(np.where(~ok, idx, -1), axis=1)
    runlen = idx - last_false
    hit = runlen >= k
    any_hit = hit.any(axis=1)
    j = np.argmax(hit, axis=1)             # first index with run >= k
    return np.where(any_hit, j - (k - 1), 0)


def clip_semialigned(res: dict, suffix: str, genome_codes: np.ndarray,
                     bases: np.ndarray,
                     row_mask: np.ndarray | None = None) -> int:
    """Soft-clip poorly aligned read ends (5-consecutive-match rule),
    vectorized across the batch (the reference walks per-cluster,
    SemialignedEndsClipper.cpp; a per-read Python walk dominated the
    host half of the pipeline).  `row_mask` restricts processing to a
    row subset (the rescued ends, whose alignment the device-side clip of
    pipeline.semialigned_clip_device did not see).  Returns the number of
    rows clipped."""
    aligned = np.asarray(res["aligned" + suffix]).astype(bool)
    if row_mask is not None:
        aligned = aligned & row_mask
    key = "cigar" + suffix
    n_rows, l = bases.shape
    if key not in res:
        res[key] = [None] * n_rows
    if not aligned.any():
        return 0
    cigars = res[key]

    # rows eligible: aligned, cigar absent or pure S/M (gapped alignments
    # keep their realigned ends, like the reference)
    rows = np.nonzero(aligned)[0]
    lead, tail, gapless = clip_spans([cigars[i] for i in rows.tolist()])
    if not gapless.any():
        return 0
    rows, lead, tail = rows[gapless], lead[gapless], tail[gapless]

    start = np.asarray(res["start" + suffix])[rows].astype(np.int64)
    rev = np.asarray(res["reverse" + suffix])[rows].astype(bool)

    # oriented read sequences (vectorized revcomp)
    sub = bases[rows]
    rc = sub[:, ::-1]
    rc = np.where(rc < 4, 3 - rc, rc)
    seq = np.where(rev[:, None], rc, sub)

    # per-position match against the reference window; position j of the
    # oriented read sits at genome (start - lead + j)
    g = genome_codes.shape[0]
    col = np.arange(l, dtype=np.int64)[None, :]
    gpos = start[:, None] - lead[:, None] + col
    ref = genome_codes[np.clip(gpos, 0, g - 1)]
    core = (col >= lead[:, None]) & (col < l - tail[:, None]) & \
        (gpos >= 0) & (gpos < g)
    match = (seq == dna.N) | ((seq == ref) & (ref != dna.N))
    ok = match & core
    # positions outside the core must not join runs nor count as mismatch
    mism = ~match & core

    core_len = (l - tail - lead).astype(np.int64)
    # left scan over the core: shift so core starts at column 0
    left = _first_run_start(ok, CONSECUTIVE_MATCHES_MIN) - lead
    left = np.maximum(left, 0)
    # right scan: reverse each row's core; easiest as a flipped array
    right = _first_run_start(ok[:, ::-1], CONSECUTIVE_MATCHES_MIN) - tail
    right = np.maximum(right, 0)

    clip_any = (left > 0) | (right > 0)
    fits = left + right + CONSECUTIVE_MATCHES_MIN < core_len
    do = clip_any & fits
    if not do.any():
        return 0

    # removed mismatches via prefix sums over the core
    mism_cum = np.cumsum(mism, axis=1)
    last = np.maximum(lead + left - 1, 0)
    left_mm = np.where(left > 0,
                       np.take_along_axis(mism_cum, last[:, None], 1)[:, 0]
                       - np.where(lead > 0,
                                  np.take_along_axis(
                                      mism_cum,
                                      np.maximum(lead - 1, 0)[:, None],
                                      1)[:, 0], 0), 0)
    total_mm = np.take_along_axis(mism_cum, np.full_like(last, l - 1)[:, None],
                                  1)[:, 0]
    upto_keep = np.take_along_axis(
        mism_cum, np.maximum(l - tail - right - 1, 0)[:, None], 1)[:, 0]
    right_mm = total_mm - upto_keep
    removed = np.where(do, left_mm + right_mm, 0)

    k = np.nonzero(do)[0]
    new_lead, new_tail = lead[k] + left[k], tail[k] + right[k]
    new_start = start[k] + left[k]
    nm = _aligned_edits(genome_codes, bases[rows[k]], rev[k], new_start,
                        new_lead, l - new_lead - new_tail)
    _set_clipped(res, suffix, rows[k], new_lead, l - new_lead - new_tail,
                 new_tail, new_start, nm, removed[k])
    return int(k.size)


def apply_semialigned_device(res: dict, suffix: str, read_len: int,
                             genome_codes: np.ndarray, bases: np.ndarray,
                             skip_rows: np.ndarray | None = None) -> int:
    """Apply the device-computed semialigned clip (pipeline.
    semialigned_clip_device outputs sa_do/sa_lead/sa_tail/sa_removed/
    sa_pos riding the result dict) — rewrite CIGARs/positions for flagged
    rows whose final cigar carries no indels (rows replaced by gapped
    polish keep their realigned ends) and recount their NM over the bases
    left aligned (`bases`, the host's masked copies, on `genome_codes`;
    a read N the clip takes off is an edit NM no longer holds, which
    `sa_removed`, the scoring mismatches, leaves out).  `skip_rows`
    (indices) are rows whose alignment is no longer the one the device
    clipped.  Returns the number of rows clipped."""
    s = suffix
    do = np.asarray(res["sa_do" + s]).astype(bool)
    if skip_rows is not None and skip_rows.size:
        do = do.copy()
        do[skip_rows] = False
    rows = np.nonzero(do)[0]
    if rows.size == 0:
        return 0
    key = "cigar" + s
    if key not in res:
        res[key] = [None] * do.shape[0]
    lead_a = res["sa_lead" + s]
    tail_a = res["sa_tail" + s]
    removed_a = res["sa_removed" + s]
    pos_a = res["sa_pos" + s]
    # gapped polish replaced the alignment of rows whose CIGAR has a gap
    rows = rows[clip_spans([res[key][i] for i in rows.tolist()])[2]]
    if rows.size == 0:
        return 0
    lead = np.asarray(lead_a)[rows].astype(np.int64)
    tail = np.asarray(tail_a)[rows].astype(np.int64)
    pos = np.asarray(pos_a)[rows].astype(np.int64)
    rev = np.asarray(res["reverse" + s])[rows].astype(bool)
    body = read_len - lead - tail
    nm = _aligned_edits(genome_codes, bases[rows], rev, pos, lead, body)
    _set_clipped(res, s, rows, lead, body, tail, pos, nm,
                 np.asarray(removed_a)[rows])
    return int(rows.size)


def apply_quality_trim_masks(bases: np.ndarray, quals: np.ndarray,
                             host_trims: np.ndarray,
                             qtrim: np.ndarray) -> np.ndarray:
    """Re-apply the device quality trim's masking to the HOST copies of a
    batch (in place) so downstream host stages (gapped polish, record
    building) see exactly what the device scorer saw.  Returns the
    combined per-read trim counts."""
    total = host_trims + qtrim
    rows = np.nonzero(qtrim)[0]
    if rows.size:
        l = bases.shape[1]
        # int16 columns: int64 masks over a batch cost more than the masking
        stop = (l - host_trims[rows]).astype(np.int16)[:, None]
        col = np.arange(l, dtype=np.int16)[None, :]
        mask = (col >= stop - qtrim[rows].astype(np.int16)[:, None]) & \
            (col < stop)
        for plane, fill in ((bases, dna.N), (quals, 0)):
            sub = plane[rows]
            np.copyto(sub, fill, where=mask, casting="unsafe")
            plane[rows] = sub
    return total


def clip_spans(cigars: list):
    """(lead soft clip, tail soft clip, gapless) of each row's CIGAR (None:
    the whole read aligned), int64 and bool arrays; each distinct CIGAR is
    parsed once (a batch holds few)."""
    ids: dict = {}
    which = np.fromiter((ids.setdefault(c, len(ids)) for c in cigars),
                        np.int64, len(cigars))
    table = np.array([_spans_of(c) for c in ids], np.int64).reshape(-1, 3)
    return table[which, 0], table[which, 1], table[which, 2].astype(bool)


def _spans_of(cigar: str | None) -> tuple[int, int, int]:
    if not cigar:
        return 0, 0, 1
    ops = parse_cigar(cigar)
    lead = ops[0][0] if ops[0][1] == "S" else 0
    tail = ops[-1][0] if len(ops) > 1 and ops[-1][1] == "S" else 0
    return lead, tail, int(not any(op in "IDN" for _n, op in ops))


def clip_overlapping(res: dict, b1, b2, genome_codes: np.ndarray) -> int:
    """Clip the lower-quality end of overlapping FR pairs (gapless only);
    returns the number of ends clipped.

    Each end is taken as it stands: its start and CIGAR after the
    masked-tail, contig-end and semialigned clips, whose soft clips it
    keeps.  A pair qualifies when both ends are aligned without a gap, the
    leftmost aligned end (end 1 on equal starts) is forward and the other
    reverse, and the two aligned spans overlap by less than either.  The
    summed base quality of each end's aligned bases inside the overlap (its
    3' tail there) decides: the lower one loses the overlap, the right end
    on a tie.  The forward loser grows its tail soft clip, the reverse
    loser its lead soft clip with the start moved past it; the loser's NM
    is recounted over the bases still aligned (a read N, or a base unlike
    the genome's, is an edit).  Vectorized but for the CIGAR strings of
    candidate and clipped rows.  Reference analog: OverlappingEndsClipper
    (lib/alignment/matchSelector/OverlappingEndsClipper.cpp)."""
    n = res["aligned_1"].shape[0]
    a = (np.asarray(res["aligned_1"]).astype(bool)
         & np.asarray(res["aligned_2"]).astype(bool))
    r1 = np.asarray(res["reverse_1"]).astype(bool)
    r2 = np.asarray(res["reverse_2"]).astype(bool)
    rows = np.nonzero(a & (r1 != r2))[0]
    if rows.size == 0:
        return 0
    l1, l2 = b1.read_len, b2.read_len
    p1 = np.asarray(res["start_1"])[rows].astype(np.int64)
    p2 = np.asarray(res["start_2"])[rows].astype(np.int64)
    left_is_1 = p1 <= p2
    lp = np.where(left_is_1, p1, p2)
    rp = np.where(left_is_1, p2, p1)
    # leftmost must face forward (FR), else mate-pair/adapter; the aligned
    # spans can overlap only where the whole left read would reach rp
    near = ~np.where(left_is_1, r1[rows], r2[rows]) & \
        (lp + np.where(left_is_1, l1, l2) > rp)
    rows, p1, p2, left_is_1, lp, rp = (
        x[near] for x in (rows, p1, p2, left_is_1, lp, rp))
    if rows.size == 0:
        return 0
    spans = []
    for sfx, length in (("_1", l1), ("_2", l2)):
        cig = res.get("cigar" + sfx) or [None] * n
        lead, tail, ok = clip_spans([cig[i] for i in rows.tolist()])
        spans.append((lead, length - lead - tail, tail, ok))
    (lead1, m1, tail1, ok1), (lead2, m2, tail2, ok2) = spans
    lm = np.where(left_is_1, m1, m2)
    rm = np.where(left_is_1, m2, m1)
    overlap = lp + lm - rp
    keep = ok1 & ok2 & (overlap > 0) & (overlap < lm) & (overlap < rm)
    if not keep.any():
        return 0
    rows, left_is_1, overlap = rows[keep], left_is_1[keep], overlap[keep]
    p1, p2 = p1[keep], p2[keep]
    lead1, m1, tail1 = lead1[keep], m1[keep], tail1[keep]
    lead2, m2, tail2 = lead2[keep], m2[keep], tail2[keep]

    def overlap_quality(quals, lead, m, length, is_left):
        # the end's aligned bases inside the overlap, as sequenced: the
        # last `overlap` aligned of a forward (left) end, the first of a
        # reverse (right) one, whose oriented index j is length-1-j read
        cs = np.concatenate([np.zeros((rows.size, 1), np.int64),
                             np.cumsum(quals[rows].astype(np.int64), 1)], 1)
        lo = np.where(is_left, lead + m - overlap, length - lead - overlap)
        hi = lo + overlap
        return (np.take_along_axis(cs, hi[:, None], 1)
                - np.take_along_axis(cs, lo[:, None], 1))[:, 0]

    q1 = overlap_quality(b1.quals, lead1, m1, l1, left_is_1)
    q2 = overlap_quality(b2.quals, lead2, m2, l2, ~left_is_1)
    # loser: the right end when the left one's quality is not lower
    clip_right = np.where(left_is_1, q1 >= q2, q2 >= q1)
    clip_1 = clip_right != left_is_1
    for key in ("cigar_1", "cigar_2"):
        if key not in res:
            res[key] = [None] * n
    for e, sel in ((1, clip_1), (2, ~clip_1)):
        k = np.nonzero(sel)[0]
        if k.size == 0:
            continue
        sfx = f"_{e}"
        bases = (b1 if e == 1 else b2).bases
        lead, m, tail = ((lead1, m1, tail1) if e == 1 else
                         (lead2, m2, tail2))
        o, right = overlap[k], clip_right[k]
        lead = np.where(right, lead[k] + o, lead[k])
        tail = np.where(right, tail[k], tail[k] + o)
        start = (p1 if e == 1 else p2)[k] + np.where(right, o, 0)
        m = m[k] - o
        rr = rows[k]
        rev = np.asarray(res["reverse" + sfx])[rr].astype(bool)
        nm = _aligned_edits(genome_codes, bases[rr], rev, start, lead, m)
        _set_clipped(res, sfx, rr, lead, m, tail, start, nm)
    return int(rows.size)


def _sm_cigar(lead: int, body: int, tail: int) -> str:
    return (f"{lead}S" if lead else "") + f"{body}M" + \
        (f"{tail}S" if tail else "")


def _write_sm_cigars(cigars: list, rows: np.ndarray, lead: np.ndarray,
                     body: np.ndarray, tail: np.ndarray) -> None:
    """Write the gapless CIGAR of `lead`, `body`, `tail` into `cigars` at
    `rows`, each distinct string built once."""
    base = int(max(lead.max(), body.max(), tail.max())) + 1
    key = (lead.astype(np.int64) * base + body) * base + tail
    uniq, inv = np.unique(key, return_inverse=True)
    strs = [_sm_cigar(int(u) // base // base, int(u) // base % base,
                      int(u) % base) for u in uniq.tolist()]
    for i, j in zip(rows.tolist(), inv.ravel().tolist()):
        cigars[i] = strs[j]


def _set_clipped(res: dict, s: str, rows: np.ndarray, lead, body, tail,
                 start, nm, removed=None) -> None:
    """An end's fields after a clip of `rows`: CIGAR, start and NM, and
    less the `removed` scoring mismatches when given."""
    _write_sm_cigars(res["cigar" + s], rows, lead, body, tail)
    res["start" + s][rows] = start
    res["edit_distance" + s][rows] = nm
    if removed is not None:
        mm = res["mismatches" + s]
        mm[rows] = np.maximum(0, mm[rows].astype(np.int64) - removed)


def _aligned_edits(genome_codes: np.ndarray, bases: np.ndarray,
                   rev: np.ndarray, start: np.ndarray, lead: np.ndarray,
                   m: np.ndarray) -> np.ndarray:
    """Edits (a read N, or a read base unlike the genome's) of gapless
    alignments: oriented read columns [lead, lead + m) against the genome
    from `start`."""
    l = bases.shape[1]
    seq = bases.copy()
    rc = bases[rev, ::-1]
    seq[rev] = np.where(rc < 4, 3 - rc, rc)
    gpos = (start - lead).astype(np.int64)[:, None] + np.arange(l)
    np.clip(gpos, 0, genome_codes.shape[0] - 1, out=gpos)
    col = np.arange(l, dtype=np.int16)[None, :]
    inside = (col >= lead.astype(np.int16)[:, None]) & \
        (col < (lead + m).astype(np.int16)[:, None])
    edit = (seq != genome_codes[gpos]) | (seq == dna.N)
    return (edit & inside).sum(axis=1)
