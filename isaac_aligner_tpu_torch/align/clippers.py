"""Read clipping on the host: adapter masking, quality-trim masks, masked
tails, contig ends, semialigned ends.

The port's own copy of the parts of `isaac_aligner_tpu/align/clippers.py`
that the single-end path calls, unchanged.  Reference analogs:
- FragmentSequencingAdapterClipper
  (lib/alignment/matchSelector/FragmentSequencingAdapterClipper.cpp):
  known adapter sequences found near the 3' end are masked.  This
  implementation masks a suffix whose prefix matches an adapter with at
  most one mismatch.
- SemialignedEndsClipper (lib/alignment/matchSelector/
  SemialignedEndsClipper.cpp): soft-clip aligned ends until
  CONSECUTIVE_MATCHES_MIN=5 consecutive matches; the device computes the
  clip (pipeline.semialigned_clip_device) and `apply_semialigned_device`
  writes it into the result dict.

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
