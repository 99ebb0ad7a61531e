"""Known-gap realignment of the output bins.

Reference analog: build::GapRealigner + RealignerGaps
(src/c++/include/build/GapRealigner.hh:37-120,
src/c++/lib/build/GapRealigner.cpp:494-1053): during the BAM-build phase,
collect every indel gap observed by any read of the bin (grouped per
sample / per project / across all samples, flag --realign-gaps), then for
each fragment enumerate combinations of known gaps overlapping its span
(findStartPos/verifyGapsChoice), accept a choice that strictly reduces
the mismatch count (applyChoice), preserve the original CIGAR in the OC
tag, and patch mate position / template length on both ends
(updatePairDetails).

Framing: this is a bin-local host post-pass exactly like the
reference's (it runs in the Build phase, after the device alignment
pipeline).  The mismatch counting for every (read, gap-choice) candidate
is vectorized numpy over the genome/read code arrays rather than the
reference's per-base scalar walk; the combination enumeration keeps the
reference's bounded shape (at most MAX_GAPS_AT_A_TIME gaps per choice).

The port's own copy of the columnar path of
`isaac_aligner_tpu/build/realign.py` (`realign_batch`,
`_patch_mates_columnar` and their helpers), unchanged but for the
template length the mate patch writes: from the leftmost aligned base of
the pair to the rightmost (the JAX package ends it at the right end's
last base, which a clipped right end can leave short of its mate's;
ROADMAP section C).  The record-list
`realign_records`, which the JAX package keeps as the test oracle of the
columnar path, is not copied.
"""

from __future__ import annotations

import itertools

import numpy as np

from ..align.gapped import NORM_EXTEND, NORM_MAX_EXTEND, NORM_MISMATCH, NORM_OPEN
from ..io.fasta import Genome

#: max known gaps combined into one realignment choice (the reference
#: enumerates combinations of overlapping gaps with a comparable bound —
#: GapRealigner::realign gives up on overly gap-dense regions)
MAX_GAPS_AT_A_TIME = 4

#: max candidate gaps per read span before giving up entirely
MAX_OVERLAPPING_GAPS = 10

#: gap slots per evaluated choice (own alignments may carry more gaps
#: than MAX_GAPS_AT_A_TIME; 6 covers both without a second code path)
_SLOTS = 6


def _collect_gaps_columnar(fb, donor_rows: np.ndarray):
    """Unique (ref_id, pos, length, is_ins) gaps from cigar columns —
    the vectorized RealignerGaps::addGapsFromFragment."""
    ops = fb.cigar_ops[donor_rows]
    nc = fb.n_cigar[donor_rows].astype(np.int64)
    c = ops.shape[1]
    ln = (ops >> 4).astype(np.int64)
    opc = (ops & 0xF).astype(np.int64)
    valid = np.arange(c)[None, :] < nc[:, None]
    # ref-consuming ops: M, D, N, =, X  (codes 0, 2, 3, 7, 8)
    rc = np.isin(opc, (0, 2, 3, 7, 8)) & valid
    lens_rc = np.where(rc, ln, 0)
    excl = np.cumsum(lens_rc, axis=1) - lens_rc
    op_ref = fb.pos[donor_rows].astype(np.int64)[:, None] + excl
    is_gap = ((opc == 1) | (opc == 2)) & valid
    r2, c2 = np.nonzero(is_gap)
    if r2.size == 0:
        return np.zeros((0, 4), np.int64)
    recs = np.stack([
        fb.ref_id[donor_rows][r2].astype(np.int64),
        op_ref[r2, c2],
        ln[r2, c2],
        (opc[r2, c2] == 1).astype(np.int64),
    ], axis=1)
    return np.unique(recs, axis=0)    # lexsorted: (ref, pos, len, ins)


def _combo_masks(n_gaps: int, max_gaps: int = MAX_GAPS_AT_A_TIME
                 ) -> np.ndarray:
    """Bitmasks of all 1..MAX_GAPS_AT_A_TIME-subsets of n_gaps gaps, in
    the legacy enumeration order (size ascending, lexicographic)."""
    out = []
    for r_ in range(1, min(n_gaps, max_gaps) + 1):
        for combo in itertools.combinations(range(n_gaps), r_):
            m = 0
            for j in combo:
                m |= 1 << j
            out.append(m)
    return np.asarray(out, np.int64)


def _eval_choices(seq_rows, gpos, glen, gins, n_gaps, start, read_span,
                  clen, gcodes_c, chunk_rows: int = 4096):
    """Vectorized _choice_cigar + mismatch count over W work items.

    seq_rows: uint8 [W, Lmax] core read codes (4-padded); gpos/glen/gins:
    [W, _SLOTS] chosen-gap columns in pos order (padded); start/read_span/
    clen: [W]; gcodes_c: the CONTIG's genome codes (local coords).
    Returns (mm [W], invalid [W], seg_roff/seg_rpos/seg_len [W, _SLOTS+1]).
    """
    w = start.shape[0]
    lmax = seq_rows.shape[1]
    seg_roff = np.zeros((w, _SLOTS + 1), np.int64)
    seg_rpos = np.zeros((w, _SLOTS + 1), np.int64)
    seg_len = np.zeros((w, _SLOTS + 1), np.int64)
    invalid = np.zeros(w, bool)
    roff = np.zeros(w, np.int64)
    rpos = start.astype(np.int64).copy()
    for j in range(_SLOTS):
        active = j < n_gaps
        head = gpos[:, j] - rpos
        bad = active & (head <= 0)
        bad |= active & (gins[:, j] != 0) \
            & (roff + head + glen[:, j] >= read_span)
        bad |= active & (gins[:, j] == 0) & (roff + head >= read_span)
        invalid |= bad
        seg_roff[:, j] = roff
        seg_rpos[:, j] = rpos
        seg_len[:, j] = np.where(active, head, 0)
        roff += np.where(active, head + gins[:, j] * glen[:, j], 0)
        rpos += np.where(active, head + (1 - gins[:, j]) * glen[:, j], 0)
    tail = read_span - roff
    last = np.minimum(n_gaps, _SLOTS)
    rows_w = np.arange(w)
    seg_roff[rows_w, last] = roff
    seg_rpos[rows_w, last] = rpos
    seg_len[rows_w, last] = np.where(invalid, 0, tail)
    # contig-end bound (segs[-1] end > clen -> invalid)
    invalid |= (rpos + tail) > clen

    # per-base mismatch count: base b of the core read belongs to the
    # segment covering it (inserted bases belong to none)
    mm = np.zeros(w, np.int64)
    gl = gcodes_c.shape[0]
    for lo in range(0, w, chunk_rows):
        hi = min(lo + chunk_rows, w)
        b = np.arange(lmax, dtype=np.int64)[None, :]           # [1, L]
        in_read = b < read_span[lo:hi, None]
        ref_b = np.zeros((hi - lo, lmax), np.int64)
        covered = np.zeros((hi - lo, lmax), bool)
        for j in range(_SLOTS + 1):
            r0 = seg_roff[lo:hi, j, None]
            sl = seg_len[lo:hi, j, None]
            in_seg = (b >= r0) & (b < r0 + sl)
            ref_b = np.where(in_seg,
                             seg_rpos[lo:hi, j, None] + (b - r0), ref_b)
            covered |= in_seg
        covered &= in_read
        ref = gcodes_c[np.clip(ref_b, 0, gl - 1)]
        rd = seq_rows[lo:hi]
        mm[lo:hi] = np.sum(((rd != ref) | (rd >= 4) | (ref >= 4)) & covered,
                           axis=1)
    return mm, invalid, seg_roff, seg_rpos, seg_len


def realign_batch(fb, genome: Genome, scope_rows: np.ndarray | None = None,
                  max_gaps: int = MAX_GAPS_AT_A_TIME,
                  realign_dodgy: bool = True) -> int:
    """Gap-realign a FragmentBatch in place — fully columnar.

    Reference semantics (GapRealigner.cpp:494-1053) preserved exactly
    (the JAX package's differential test pins this path against its
    `realign_records`):
    collect gaps from all cigars, enumerate 1..4-gap combinations of the
    gaps overlapping each read span, accept the strictly-best
    (mismatches, normalized score, gap count) choice, rewrite CIGAR/NM,
    keep the original CIGAR in OC, and patch mate PNEXT/TLEN.

    No per-record Python: gap harvest, work-list construction, choice
    validation, mismatch counting, selection and application are all
    numpy array passes; only per-CONTIG and per-combo-size loops remain
    (VERDICT r3 missing #6).  `scope_rows` restricts gap sharing
    (per-sample / per-project --realign-gaps scopes).  Returns #records
    changed.
    """
    from ..io import sam as sam_mod
    from . import records as R

    n = len(fb)
    if n == 0:
        return 0
    if max_gaps > _SLOTS:
        # the choice evaluator carries _SLOTS static gap slots; clamping
        # (with a visible log) beats an IndexError mid-Build
        from ..utils import tracing
        tracing.log(f"--realigned-gaps-per-fragment {max_gaps} clamped to "
                    f"{_SLOTS} (static choice-slot capacity)", force=True)
        max_gaps = _SLOTS
    rows = np.arange(n) if scope_rows is None else np.asarray(scope_rows)
    sub_mask = np.zeros(n, bool)
    sub_mask[rows] = True
    mapped = sub_mask & (~(fb.flag & sam_mod.FLAG_UNMAPPED).astype(bool)) \
        & (fb.ref_id >= 0) & (fb.n_cigar > 0)
    if not realign_dodgy:
        # reference --realign-dodgy=0 (manual.md:467): records without
        # an alignment score (SM absent — untrackable repeat placements)
        # are NOT realigned against gaps found in other reads; they
        # still DONATE their gaps below
        mapped = mapped & (fb.sm != R._ABSENT)

    # donor rows: any I/D op inside the cigar
    c = fb.cigar_ops.shape[1]
    valid = np.arange(c)[None, :] < fb.n_cigar[:, None]
    opc_all = (fb.cigar_ops & 0xF).astype(np.int32)
    has_gap = (((opc_all == 1) | (opc_all == 2)) & valid).any(axis=1) & mapped
    if not has_gap.any():
        return 0
    gaps = _collect_gaps_columnar(fb, np.nonzero(has_gap)[0])
    if gaps.shape[0] == 0:
        return 0

    # eligible rows: soft clips at the edges only, core ops in {M, I, D}
    lead, tail_clip = R.clip_spans(fb.cigar_ops, fb.n_cigar)
    core_pos = np.arange(c)[None, :]
    is_lead_s = (core_pos == 0) & (lead[:, None] > 0)
    is_tail_s = (core_pos == (fb.n_cigar - 1)[:, None]) & \
        (tail_clip[:, None] > 0)
    core_mask = valid & ~is_lead_s & ~is_tail_s
    core_ok = ~np.any(core_mask & ~np.isin(opc_all, (0, 1, 2)), axis=1) \
        & np.any(core_mask, axis=1)
    ln_all = (fb.cigar_ops >> 4).astype(np.int64)
    read_span_all = np.sum(
        np.where(core_mask & ((opc_all == 0) | (opc_all == 1)), ln_all, 0),
        axis=1)
    ref_span_all = np.sum(
        np.where(core_mask & ((opc_all == 0) | (opc_all == 2)), ln_all, 0),
        axis=1)
    eligible = mapped & core_ok & (read_span_all > 0)

    n_changed = 0
    changed_rows_all: list[np.ndarray] = []
    new_ops_all: list[np.ndarray] = []
    new_nops_all: list[np.ndarray] = []
    new_nm_all: list[np.ndarray] = []
    cand_mask = np.zeros(n, bool)   # rows whose span overlaps a known gap

    for ci, contig in enumerate(genome.contigs):
        gsel = gaps[gaps[:, 0] == ci]
        if gsel.shape[0] == 0:
            continue
        on = np.nonzero(eligible & (fb.ref_id == ci))[0]
        if on.size == 0:
            continue
        gp = gsel[:, 1]
        start = fb.pos[on].astype(np.int64)
        lo = np.searchsorted(gp, start, side="right")
        hi = np.searchsorted(gp, start + ref_span_all[on], side="left")
        n_over = hi - lo
        cand_mask[on[n_over > 0]] = True
        keep = (n_over > 0) & (n_over <= MAX_OVERLAPPING_GAPS)
        on, lo, hi, n_over = on[keep], lo[keep], hi[keep], n_over[keep]
        if on.size == 0:
            continue
        start = fb.pos[on].astype(np.int64)
        rspan = read_span_all[on]
        lmax = int(rspan.max())
        gcodes_c = genome.codes[contig.offset : contig.offset + contig.length]

        # core read codes, 4-padded to lmax (output orientation == stored)
        lead_on = lead[on].astype(np.int64)
        bcols = np.arange(lmax, dtype=np.int64)[None, :]
        src = lead_on[:, None] + bcols
        seqw = fb.seq.shape[1]
        seq_core = np.where(
            bcols < rspan[:, None],
            fb.seq[on[:, None], np.clip(src, 0, seqw - 1)], 4
        ).astype(np.uint8)

        # ---- own-choice evaluation (current alignment's cost) -----------
        ops_on = fb.cigar_ops[on]
        nc_on = fb.n_cigar[on].astype(np.int64)
        opc_on = (ops_on & 0xF).astype(np.int64)
        ln_on = (ops_on >> 4).astype(np.int64)
        v_on = np.arange(c)[None, :] < nc_on[:, None]
        own_is_gap = ((opc_on == 1) | (opc_on == 2)) & v_on
        own_counts = own_is_gap.sum(axis=1)
        # rows whose own cigar has more gaps than _SLOTS cannot be scored
        ok_own = own_counts <= _SLOTS
        on, lo, hi, n_over = on[ok_own], lo[ok_own], hi[ok_own], n_over[ok_own]
        if on.size == 0:
            continue
        start, rspan, seq_core = start[ok_own], rspan[ok_own], seq_core[ok_own]
        ops_on, nc_on = ops_on[ok_own], nc_on[ok_own]
        opc_on, ln_on, v_on = opc_on[ok_own], ln_on[ok_own], v_on[ok_own]
        own_is_gap, own_counts = own_is_gap[ok_own], own_counts[ok_own]
        lead_on = lead[on].astype(np.int64)

        rc_on = np.isin(opc_on, (0, 2, 3, 7, 8)) & v_on
        lens_rc = np.where(rc_on, ln_on, 0)
        excl = np.cumsum(lens_rc, axis=1) - lens_rc
        own_gpos = np.zeros((on.size, _SLOTS), np.int64)
        own_glen = np.zeros((on.size, _SLOTS), np.int64)
        own_gins = np.zeros((on.size, _SLOTS), np.int64)
        r3, c3 = np.nonzero(own_is_gap)
        slot = (np.cumsum(own_is_gap, axis=1) - 1)[r3, c3]
        own_gpos[r3, slot] = start[r3] + excl[r3, c3]
        own_glen[r3, slot] = ln_on[r3, c3]
        own_gins[r3, slot] = (opc_on[r3, c3] == 1).astype(np.int64)
        own_mm, own_bad, _, _, _ = _eval_choices(
            seq_core, own_gpos, own_glen, own_gins, own_counts, start,
            rspan, np.full(on.size, contig.length, np.int64), gcodes_c)
        own_gap_norm = np.sum(
            np.where(own_is_gap,
                     NORM_OPEN + np.minimum(NORM_MAX_EXTEND,
                                            (ln_on - 1) * NORM_EXTEND), 0),
            axis=1)
        own_score = np.stack([own_mm, own_mm * NORM_MISMATCH + own_gap_norm,
                              own_counts], axis=1)
        ok2 = ~own_bad
        if not ok2.all():
            (on, lo, hi, n_over, start, rspan, seq_core, own_score,
             lead_on) = (x[ok2] for x in (
                 on, lo, hi, n_over, start, rspan, seq_core, own_score,
                 lead_on))
        if on.size == 0:
            continue

        # ---- work-list: (row, combo) pairs ------------------------------
        w_row: list[np.ndarray] = []
        w_mask: list[np.ndarray] = []
        w_ord: list[np.ndarray] = []
        for g in np.unique(n_over):
            masks = _combo_masks(int(g), max_gaps)
            rsel = np.nonzero(n_over == g)[0]
            w_row.append(np.repeat(rsel, masks.size))
            w_mask.append(np.tile(masks, rsel.size))
            w_ord.append(np.tile(np.arange(masks.size), rsel.size))
        w_row = np.concatenate(w_row)
        w_mask = np.concatenate(w_mask)
        w_ord = np.concatenate(w_ord)

        # chosen-gap slot columns (combination of a pos-sorted list stays
        # pos-sorted)
        gpos_w = np.zeros((w_row.size, _SLOTS), np.int64)
        glen_w = np.zeros((w_row.size, _SLOTS), np.int64)
        gins_w = np.zeros((w_row.size, _SLOTS), np.int64)
        n_w = np.zeros(w_row.size, np.int64)
        for j in range(MAX_OVERLAPPING_GAPS):
            inb = (j < n_over[w_row]) & ((w_mask >> j) & 1).astype(bool)
            gi = np.minimum(lo[w_row] + j, gp.shape[0] - 1)
            slot2 = n_w.copy()
            sel = np.nonzero(inb)[0]
            gpos_w[sel, slot2[sel]] = gsel[gi[sel], 1]
            glen_w[sel, slot2[sel]] = gsel[gi[sel], 2]
            gins_w[sel, slot2[sel]] = gsel[gi[sel], 3]
            n_w[sel] += 1

        mm_w, bad_w, s_roff, s_rpos, s_len = _eval_choices(
            seq_core[w_row], gpos_w, glen_w, gins_w, n_w, start[w_row],
            rspan[w_row], np.full(w_row.size, contig.length, np.int64),
            gcodes_c)
        gap_norm_w = np.sum(
            np.where(np.arange(_SLOTS)[None, :] < n_w[:, None],
                     NORM_OPEN + np.minimum(NORM_MAX_EXTEND,
                                            (glen_w - 1) * NORM_EXTEND), 0),
            axis=1)
        norm_w = mm_w * NORM_MISMATCH + gap_norm_w

        # strict improvement over the row's own score, legacy tuple order
        better = ~bad_w & (
            (mm_w < own_score[w_row, 0])
            | ((mm_w == own_score[w_row, 0]) & (norm_w < own_score[w_row, 1]))
            | ((mm_w == own_score[w_row, 0]) & (norm_w == own_score[w_row, 1])
               & (n_w < own_score[w_row, 2])))
        if not better.any():
            continue

        # best per row: lexicographic (mm, norm, count, enum order);
        # earliest-ordinal tie-break reproduces the legacy first-wins scan
        sel = np.nonzero(better)[0]
        order = np.lexsort((w_ord[sel], n_w[sel], norm_w[sel], mm_w[sel],
                            w_row[sel]))
        sel = sel[order]
        first = np.concatenate([[True],
                                w_row[sel][1:] != w_row[sel][:-1]])
        win = sel[first]

        # ---- apply: rebuild cigar columns for the winners ----------------
        rows_c = on[w_row[win]]
        n_win = win.size
        max_ops = 2 * _SLOTS + 3
        new_ops = np.zeros((n_win, max_ops), np.uint32)
        new_n = np.zeros(n_win, np.int64)
        lead_w = lead_on[w_row[win]]
        has_lead = lead_w > 0
        new_ops[has_lead, 0] = (lead_w[has_lead].astype(np.uint32) << 4) | 4
        new_n += has_lead
        rows_i = np.arange(n_win)
        for j in range(_SLOTS):
            active = j < n_w[win]
            m_len = s_len[win, j]
            put_m = active & (m_len > 0)
            new_ops[rows_i[put_m], new_n[put_m]] = \
                (m_len[put_m].astype(np.uint32) << 4) | 0
            new_n[put_m] += 1
            gl_w = glen_w[win, j]
            gop = np.where(gins_w[win, j] == 1, 1, 2).astype(np.uint32)
            new_ops[rows_i[active], new_n[active]] = \
                (gl_w[active].astype(np.uint32) << 4) | gop[active]
            new_n[active] += 1
        tail_idx = n_w[win]
        t_len = s_len[win, tail_idx]
        put_t = t_len > 0
        new_ops[rows_i[put_t], new_n[put_t]] = \
            (t_len[put_t].astype(np.uint32) << 4) | 0
        new_n[put_t] += 1
        tclip = tail_clip[rows_c].astype(np.int64)
        has_tail = tclip > 0
        new_ops[rows_i[has_tail], new_n[has_tail]] = \
            (tclip[has_tail].astype(np.uint32) << 4) | 4
        new_n[has_tail] += 1

        nm_new = mm_w[win] + np.sum(
            np.where(np.arange(_SLOTS)[None, :] < n_w[win][:, None],
                     glen_w[win], 0), axis=1)
        changed_rows_all.append(rows_c)
        new_ops_all.append(new_ops)
        new_nops_all.append(new_n)
        new_nm_all.append(nm_new)
        n_changed += n_win

    if not n_changed:
        return 0

    # ---- write back ------------------------------------------------------
    rows_c = np.concatenate(changed_rows_all)
    wmax = max(a.shape[1] for a in new_ops_all)
    ops_c = np.zeros((rows_c.size, wmax), np.uint32)
    o = 0
    for a in new_ops_all:
        ops_c[o : o + a.shape[0], : a.shape[1]] = a
        o += a.shape[0]
    nops_c = np.concatenate(new_nops_all)
    nm_c = np.concatenate(new_nm_all)

    # preserve original CIGARs in OC (vectorized stringify of old ops)
    _mat, _lens, old_strs = R.ops_to_strings(fb.cigar_ops[rows_c],
                                             fb.n_cigar[rows_c])
    if fb.oc is None:
        fb.oc = np.full(n, None, dtype=object)
    fb.oc[rows_c] = old_strs

    c_have = fb.cigar_ops.shape[1]
    if wmax > c_have:
        grow = np.zeros((n, wmax), np.uint32)
        grow[:, :c_have] = fb.cigar_ops
        fb.cigar_ops = grow
        grow_mc = np.zeros((n, wmax), np.uint32)
        grow_mc[:, : fb.mc_ops.shape[1]] = fb.mc_ops
        fb.mc_ops = grow_mc
    fb.cigar_ops[rows_c] = 0
    fb.cigar_ops[rows_c, :wmax] = ops_c
    fb.n_cigar[rows_c] = nops_c.astype(fb.n_cigar.dtype)
    fb.nm[rows_c] = nm_c.astype(np.int32)

    # mate patching runs over the templates the legacy path pulled: every
    # template containing a gap-overlapping row (realign_records patched
    # all pairs among the taken records, changed or not)
    tid_all = fb.template_ids()
    cand_tids = np.unique(tid_all[cand_mask])
    _patch_mates_columnar(fb, sub_mask & np.isin(tid_all, cand_tids))
    return n_changed


def _patch_mates_columnar(fb, scope: np.ndarray) -> None:
    """Vectorized PNEXT/TLEN recompute over same-contig primary pairs
    (reference GapRealigner updatePairDetails)."""
    from ..io import sam as sam_mod
    from . import records as R

    okay = scope & ((fb.flag & sam_mod.FLAG_PAIRED) != 0) \
        & (~(fb.flag & sam_mod.FLAG_UNMAPPED).astype(bool)) \
        & ((fb.flag & (sam_mod.FLAG_SECONDARY
                       | sam_mod.FLAG_SUPPLEMENTARY)) == 0)
    rows = np.nonzero(okay)[0]
    if rows.size < 2:
        return
    tid = fb.template_ids()[rows]
    order = np.argsort(tid, kind="stable")
    rows = rows[order]
    tid = tid[order]
    starts = np.flatnonzero(np.concatenate([[True], tid[1:] != tid[:-1]]))
    lens = np.diff(np.concatenate([starts, [tid.size]]))
    pairs = starts[lens == 2]
    a = rows[pairs]
    b = rows[pairs + 1]
    same = fb.ref_id[a] == fb.ref_id[b]
    a, b = a[same], b[same]
    if a.size == 0:
        return
    fb.mate_pos[a] = fb.pos[b]
    fb.mate_pos[b] = fb.pos[a]
    span_all = R.ref_span(fb.cigar_ops, fb.n_cigar).astype(np.int64)
    # the template from the leftmost aligned base to the rightmost, as the
    # records were made (storage.from_paired_result): a clipped end may
    # stop short of its mate's end; on equal starts read 1 is positive
    pa, pb = fb.pos[a].astype(np.int64), fb.pos[b].astype(np.int64)
    a_is_1 = (fb.flag[a] & sam_mod.FLAG_READ1) != 0
    a_left = (pa < pb) | ((pa == pb) & a_is_1)
    left = np.where(a_left, a, b)
    right = np.where(a_left, b, a)
    span = np.maximum(pa + span_all[a], pb + span_all[b]) \
        - np.minimum(pa, pb)
    fb.tlen[left] = span.astype(np.int32)
    fb.tlen[right] = (-span).astype(np.int32)
