"""Read clipping on the host: adapter masking, quality-trim masks, masked
tails, contig ends, semialigned ends, overlapping pair ends.

The port's own copy of the parts of `isaac_aligner_tpu/align/clippers.py`
that the single-end and paired-end paths call, unchanged.  Reference
analogs:
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
                            read_len: int) -> None:
    """Turn masked tails into soft-clips in the result dict.

    Forward alignments clip at the CIGAR end; reverse alignments carry the
    masked read-tail at the genome-left side, so the clip leads and the
    position advances by the trim (the candidate start referenced the full
    oriented read).  Also corrects NM for the masked (N-scored) bases.
    """
    key = "cigar" + suffix
    if key not in res:
        res[key] = [None] * trims.shape[0]
    for i in np.nonzero(trims)[0]:
        if not res["aligned" + suffix][i]:
            continue
        t = int(trims[i])
        body = read_len - t
        cur = res[key][i]
        if cur is not None:
            continue  # gapped cigars already reflect the masked bases as N
        if res["reverse" + suffix][i]:
            res[key][i] = f"{t}S{body}M"
            res["start" + suffix][i] += t
        else:
            res[key][i] = f"{body}M{t}S"
        res["edit_distance" + suffix][i] = max(
            0, int(res["edit_distance" + suffix][i]) - t)


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
                     row_mask: np.ndarray | None = None) -> None:
    """Soft-clip poorly aligned read ends (5-consecutive-match rule),
    vectorized across the batch (the reference walks per-cluster,
    SemialignedEndsClipper.cpp; a per-read Python walk dominated the
    host half of the pipeline).  `row_mask` restricts processing to a
    row subset (used for rescued shadows, which the device-side clip of
    pipeline.semialigned_clip_device could not see)."""
    aligned = np.asarray(res["aligned" + suffix]).astype(bool)
    if row_mask is not None:
        aligned = aligned & row_mask
    key = "cigar" + suffix
    n_rows, l = bases.shape
    if key not in res:
        res[key] = [None] * n_rows
    if not aligned.any():
        return
    cigars = res[key]

    # rows eligible: aligned, cigar absent or pure S/M (gapped alignments
    # keep their realigned ends, like the reference)
    from ..build.records import cigars_to_ops, clip_spans
    lengths = np.full(n_rows, l, np.int32)
    ops, n_ops = cigars_to_ops(list(cigars), lengths)
    opc = ops & 0xF
    valid_col = np.arange(ops.shape[1])[None, :] < n_ops[:, None]
    has_indel = (((opc == 1) | (opc == 2) | (opc == 3)) & valid_col).any(axis=1)
    lead_s, tail_s = clip_spans(ops, n_ops)
    rows_m = aligned & ~has_indel
    if not rows_m.any():
        return
    rows = np.nonzero(rows_m)[0]

    start = np.asarray(res["start" + suffix])[rows].astype(np.int64)
    rev = np.asarray(res["reverse" + suffix])[rows].astype(bool)
    lead = lead_s[rows].astype(np.int64)
    tail = tail_s[rows].astype(np.int64)

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
        return

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

    for k2 in np.nonzero(do)[0]:
        i = rows[k2]
        new_lead = int(lead[k2] + left[k2])
        new_tail = int(tail[k2] + right[k2])
        body = l - new_lead - new_tail
        parts = ([f"{new_lead}S"] if new_lead else []) + [f"{body}M"] + \
            ([f"{new_tail}S"] if new_tail else [])
        res[key][i] = "".join(parts)
        res["start" + suffix][i] = int(start[k2]) + int(left[k2])
        res["edit_distance" + suffix][i] = max(
            0, int(res["edit_distance" + suffix][i]) - int(removed[k2]))
        res["mismatches" + suffix][i] = max(
            0, int(res["mismatches" + suffix][i]) - int(removed[k2]))


def apply_semialigned_device(res: dict, suffix: str, read_len: int,
                             skip_rows: np.ndarray | None = None) -> None:
    """Apply the device-computed semialigned clip (pipeline.
    semialigned_clip_device outputs sa_do/sa_lead/sa_tail/sa_removed/
    sa_pos riding the result dict) — rewrite CIGARs/positions for flagged
    rows whose final cigar carries no indels (rows replaced by gapped
    polish keep their realigned ends)."""
    s = suffix
    do = np.asarray(res["sa_do" + s]).astype(bool)
    if skip_rows is not None and skip_rows.size:
        do = do.copy()
        do[skip_rows] = False
    rows = np.nonzero(do)[0]
    if rows.size == 0:
        return
    key = "cigar" + s
    if key not in res:
        res[key] = [None] * do.shape[0]
    lead_a = res["sa_lead" + s]
    tail_a = res["sa_tail" + s]
    removed_a = res["sa_removed" + s]
    pos_a = res["sa_pos" + s]
    for i in rows:
        cur = res[key][i]
        if cur is not None and ("I" in cur or "D" in cur):
            continue    # gapped polish replaced this row's alignment
        lead, tail = int(lead_a[i]), int(tail_a[i])
        body = read_len - lead - tail
        parts = ([f"{lead}S"] if lead else []) + [f"{body}M"] + \
            ([f"{tail}S"] if tail else [])
        res[key][i] = "".join(parts)
        res["start" + s][i] = int(pos_a[i])
        rm = int(removed_a[i])
        res["edit_distance" + s][i] = max(
            0, int(res["edit_distance" + s][i]) - rm)
        res["mismatches" + s][i] = max(
            0, int(res["mismatches" + s][i]) - rm)


def apply_quality_trim_masks(bases: np.ndarray, quals: np.ndarray,
                             host_trims: np.ndarray,
                             qtrim: np.ndarray) -> np.ndarray:
    """Re-apply the device quality trim's masking to the HOST copies of a
    batch (in place) so downstream host stages (gapped polish, record
    building) see exactly what the device scorer saw.  Returns the
    combined per-read trim counts."""
    total = host_trims + qtrim
    if qtrim.any():
        l = bases.shape[1]
        start_j = (l - 1) - host_trims.astype(np.int64)
        cut_from = start_j + 1 - qtrim
        col = np.arange(l)[None, :]
        mask = (col >= cut_from[:, None]) & (col <= start_j[:, None]) & \
            (qtrim[:, None] > 0)
        bases[mask] = dna.N
        quals[mask] = 0
    return total


def clip_overlapping(res: dict, b1, b2, genome_codes: np.ndarray) -> None:
    """Clip the lower-quality end of overlapping FR pairs (gapless only).

    Vectorized: eligibility (both aligned, FR, genuine overlap) and the
    tail-quality comparison are whole-batch column math; per-row Python
    runs only for the rows actually clipped (reads overlap only when the
    insert is shorter than the summed read lengths).  Reference analog:
    overlapping-template clipping in TemplateBuilder (buildTemplate's
    consistent-pair path)."""
    n = res["aligned_1"].shape[0]
    a = (np.asarray(res["aligned_1"]).astype(bool)
         & np.asarray(res["aligned_2"]).astype(bool))
    r1 = np.asarray(res["reverse_1"]).astype(bool)
    r2 = np.asarray(res["reverse_2"]).astype(bool)
    cand = a & (r1 != r2)
    if not cand.any():
        return
    p1 = np.asarray(res["start_1"]).astype(np.int64)
    p2 = np.asarray(res["start_2"]).astype(np.int64)
    l1, l2 = b1.read_len, b2.read_len
    left_is_1 = p1 <= p2
    lp = np.where(left_is_1, p1, p2)
    rp = np.where(left_is_1, p2, p1)
    ll = np.where(left_is_1, l1, l2)
    rl = np.where(left_is_1, l2, l1)
    left_rev = np.where(left_is_1, r1, r2)
    overlap = lp + ll - rp
    # leftmost must face forward (FR), else mate-pair/adapter
    cand &= ~left_rev & (overlap > 0) & (overlap < ll) & (overlap < rl)
    rows = np.nonzero(cand)[0]
    if rows.size == 0:
        return
    # gapless only: drop candidates whose cigar carries an indel
    c1 = res.get("cigar_1")
    c2 = res.get("cigar_2")
    if c1 is not None or c2 is not None:
        keep = []
        for i in rows:
            s1 = c1[i] if c1 is not None else None
            s2 = c2[i] if c2 is not None else None
            if (s1 and ("I" in s1 or "D" in s1)) or \
                    (s2 and ("I" in s2 or "D" in s2)):
                continue
            keep.append(i)
        rows = np.asarray(keep, np.int64)
        if rows.size == 0:
            return
    # summed qualities of the two 3' tails over the overlap span
    cs1 = np.cumsum(b1.quals[rows, ::-1].astype(np.int64), axis=1)
    cs2 = np.cumsum(b2.quals[rows, ::-1].astype(np.int64), axis=1)
    ov = overlap[rows]
    q1t = np.take_along_axis(cs1, (ov - 1)[:, None], axis=1)[:, 0]
    q2t = np.take_along_axis(cs2, (ov - 1)[:, None], axis=1)[:, 0]
    left_q = np.where(left_is_1[rows], q1t, q2t)
    right_q = np.where(left_is_1[rows], q2t, q1t)
    # loser: the right end when the left tail wins (ties keep the left)
    clip_right = left_q >= right_q
    # suffix of the clipped row (right end = the mate of the left one)
    right_is_1 = ~left_is_1[rows]
    clip_1 = np.where(clip_right, right_is_1, ~right_is_1)
    for key in ("cigar_1", "cigar_2"):
        if key not in res:
            res[key] = [None] * n
    for k, i in enumerate(rows):
        o = int(ov[k])
        sfx = "_1" if clip_1[k] else "_2"
        length = l1 if clip_1[k] else l2
        if clip_right[k]:
            # clip the genome-left start of the right (reverse) read; in
            # read coordinates that is its 3' tail -> leading S, pos shift
            res["cigar" + sfx][i] = f"{o}S{length - o}M"
            res["start" + sfx][i] = int(rp[i]) + o
        else:
            res["cigar" + sfx][i] = f"{length - o}M{o}S"
