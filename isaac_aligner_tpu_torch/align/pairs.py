"""Paired-end resolution on torch tensors: pair cross-product scoring,
template MAPQ, and TLS-window shadow rescue.

Port of `isaac_aligner_tpu/align/pairs.py` (reference TemplateBuilder,
src/c++/lib/alignment/TemplateBuilder.cpp: locateBestPair :287,
buildPairedEndTemplate :398, rescueShadow :495):
- the pair search is a dense [B, C, C] tensor op over the two ends'
  candidate lists: model id, template length, match mask, probability sums
  and the lexicographic (pair SW score, -logProb) argmin;
- shadow rescue scores every offset of the TLS mate window with the
  ungapped scorer over the packed genome planes, as a separate batch over
  host-compacted orphan rows.

`TlsStatic` is a plain frozen dataclass of ints: the fields enter the
tensor math as Python ints, so a changed model needs nothing rebuilt (the
JAX package registered it as a pytree for the same reason).  Every argmin
takes the first index on ties, as `jnp.argmin` does, and every float is
clamped into range before an integer cast, so the card and the CPU agree.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import dna
from ..ops import bitops
from . import quality
from .pipeline import (GENOME_PAD, GN_PAD_WORDS, GP_PAD_WORDS, AlignConfig,
                       IndexArrays, _funnel, genome_len_of)
from .tls import TEMPLATE_LENGTH_THRESHOLD, TemplateLengthStatistics

_NOT_PORTED_SCATTER = ("scatter_repeats is not ported yet (ROADMAP queue A: "
                       "64-mer seeds and neighbor matching)")


@dataclasses.dataclass(frozen=True)
class TlsStatic:
    """TLS snapshot: the same seven int fields as the JAX package's, so
    `Temp/AlignerState.json` reads in either package."""

    min: int = 0
    max: int = TEMPLATE_LENGTH_THRESHOLD
    mate_min: int = 0
    mate_max: int = TEMPLATE_LENGTH_THRESHOLD
    best0: int = 1   # FRp
    best1: int = 6   # RFm
    median: int = 0  # --mate-drift-range window center

    @staticmethod
    def from_stats(s: TemplateLengthStatistics) -> "TlsStatic":
        return TlsStatic(median=s.median,
                         min=s.min, max=s.max, mate_min=s.mate_min,
                         mate_max=s.mate_max,
                         best0=s.best_models[0], best1=s.best_models[1])

    def to_stats(self) -> TemplateLengthStatistics:
        s = TemplateLengthStatistics(min=self.min, max=self.max,
                                     best_models=(self.best0, self.best1))
        s.mate_min, s.mate_max = self.mate_min, self.mate_max
        return s


def quantize_rescue_window(span: int, cap: int) -> int:
    """Round a TLS mate-window span up to a power-of-two bucket (>= 256);
    when the power of two overshoots `cap` but the span fits, `cap` is the
    bucket, so the rescue on/off decision (window > cap) follows the span.
    The scan covers the bucket; offsets past the span are masked."""
    win = 256
    while win < span:
        win *= 2
    if win > cap >= span:
        win = cap
    return win


def pair_model(pos1, rev1, pos2, rev2):
    """Alignment model id (TemplateLengthStatistics.hh:153-162)."""
    pos_mask = torch.where(pos1 <= pos2, 0, 4).to(torch.int32)
    return pos_mask | (rev1.to(torch.int32) << 1) | rev2.to(torch.int32)


def pair_length(pos1, len1, pos2, len2):
    """Template length (TemplateLengthStatistics.hh:166-177)."""
    lo_first = pos1 < pos2
    span1 = pos2 + len2 - pos1
    span2 = pos1 + len1 - pos2
    return torch.where(lo_first, torch.maximum(span1, len1),
                       torch.maximum(span2, len2))


def _const(value: float, device) -> torch.Tensor:
    """A float32 scalar on `device`, filled there: a tensor copied from
    the host would make the host wait for the device's queue."""
    return torch.full((), value, dtype=torch.float32, device=device)


def _take(x, idx):
    """x[row, idx[row]] for [B, C] x and [B] idx."""
    return x.gather(1, idx[:, None])[:, 0]


def _floor_score(x, cap: int):
    """floor(x) as int32, the float clamped to [-1, cap] first: an inf or
    out-of-range float has no portable int32 cast (x86 gives INT_MIN,
    CUDA saturates), and every consumer clips to that range anyway."""
    return torch.clamp(torch.floor(x), -1.0, float(cap)).to(torch.int32)


def resolve_pairs(cfg: AlignConfig, tls: TlsStatic, end1: dict, end2: dict,
                  log_rog_template: float) -> dict:
    """Dense pair search over both candidate lists.

    Each end dict needs start, orient, valid, cid, log_prob, sw_score and
    obs_len, all [B, C].  Returns the best-pair indices, template score
    (clamped to [-1, mapq_cap]), proper flag and probability sums, [B].
    Probability mass is on the exp(-m) scale (m the row's best matched
    pair log prob); `total_prob` is scaled, `log_scale` carries m."""
    if cfg.scatter_repeats:
        raise NotImplementedError(_NOT_PORTED_SCATTER)
    p1 = end1["start"][:, :, None]
    p2 = end2["start"][:, None, :]
    r1 = end1["orient"][:, :, None]
    r2 = end2["orient"][:, None, :]
    l1 = end1["obs_len"][:, :, None]
    l2 = end2["obs_len"][:, None, :]

    same_contig = end1["cid"][:, :, None] == end2["cid"][:, None, :]
    both_valid = end1["valid"][:, :, None] & end2["valid"][:, None, :]
    model = pair_model(p1, r1, p2, r2)
    length = pair_length(p1, l1, p2, l2)
    in_models = (model == tls.best0) | (model == tls.best1)
    match = both_valid & same_contig & in_models & \
        (length <= tls.max + TEMPLATE_LENGTH_THRESHOLD)

    pair_lp = end1["log_prob"][:, :, None] + end2["log_prob"][:, None, :]
    pair_sw = end1["sw_score"][:, :, None] + end2["sw_score"][:, None, :]

    b, c1, c2 = match.shape
    inf = _const(float("inf"), p1.device)
    zero = _const(0.0, p1.device)
    m = torch.where(match, pair_lp, -inf).reshape(b, -1).amax(dim=1)
    m_safe = torch.where(torch.isfinite(m), m, zero)
    prob = torch.where(match, torch.exp(pair_lp - m_safe[:, None, None]), zero)
    total_prob = prob.sum(dim=(1, 2))
    key = torch.where(match, pair_sw.to(torch.float32) * 1e5 - pair_lp,
                      inf).reshape(b, c1 * c2)
    best_flat = torch.argmin(key, dim=1)          # first index on ties
    i1 = best_flat // c2
    i2 = best_flat % c2
    resolved = match.reshape(b, -1).any(dim=1)

    best_lp = _take(end1["log_prob"], i1) + _take(end2["log_prob"], i2)
    s1, s2 = _take(end1["start"], i1), _take(end2["start"], i2)
    best_model = pair_model(s1, _take(end1["orient"], i1),
                            s2, _take(end2["orient"], i2))
    best_len = pair_length(s1, _take(end1["obs_len"], i1),
                           s2, _take(end2["obs_len"], i2))
    proper = resolved & ((best_model == tls.best0) |
                         (best_model == tls.best1)) & \
        (best_len >= tls.min) & (best_len <= tls.max)

    # template alignment score (TemplateBuilder.cpp:435-447) on the exp(-m)
    # scale; the scale cancels in the ratio
    p_best = torch.where(resolved, torch.exp(best_lp - m_safe), zero)
    rog_s = quality.rog_scaled(log_rog_template, m_safe)
    others = torch.clamp(total_prob - p_best, min=0.0) + rog_s
    denom = total_prob + rog_s
    score_f = -10.0 * torch.log10(
        torch.clamp(others / torch.clamp(denom, min=1e-38), min=1e-38))
    template_score = torch.where(resolved, _floor_score(score_f, cfg.mapq_cap),
                                 -1)

    return {
        "resolved": resolved,
        "i1": i1,
        "i2": i2,
        "proper": proper,
        "template_length": torch.where(resolved, best_len, 0),
        "template_score": template_score,
        "total_prob": total_prob,    # scaled by exp(-log_scale)
        "log_scale": m_safe,
        "best_lp": best_lp,
    }


def end_mapping_score(end: dict, best_index, log_rog_read: float):
    """alignmentScore of the chosen fragment against its end's candidates,
    on the exp(-m) scale: (score, others_scaled, log_scale)."""
    best_lp = _take(end["log_prob"], best_index)
    total_s, p_best_s, m_safe = quality.scaled_masses(
        end["log_prob"], end["valid"], best_lp)
    # the score is finite and at most -10*log10(1e-38) = 380
    score = torch.floor(quality.mapping_quality_scaled(
        total_s, p_best_s, quality.rog_scaled(log_rog_read, m_safe))
    ).to(torch.int32)
    return score, torch.clamp(total_s - p_best_s, min=0.0), m_safe


def align_paired_batch(arrays: IndexArrays, bases1, quals1, bases2, quals2,
                       cfg: AlignConfig, tls: TlsStatic,
                       tail_masked1=None, tail_masked2=None) -> dict:
    """Paired-end alignment of one read-pair batch on the arrays' device
    (TemplateBuilder::buildTemplate, TemplateBuilder.cpp:90-140): the best
    TLS-compatible pair, or independent single-end picks for rows without
    one; shadow and disjoined rows are flagged for the host rescue.

    Returns a dict of per-end tensors (suffix _1/_2) and pair tensors."""
    from .pipeline import (quality_trim_device, score_end,
                           semialigned_clip_device)

    b, l1 = bases1.shape
    _, l2 = bases2.shape
    dev = bases1.device
    g = genome_len_of(arrays, cfg)

    def zeros():
        return torch.zeros(b, dtype=torch.int32, device=dev)

    tm1 = zeros() if tail_masked1 is None else tail_masked1
    tm2 = zeros() if tail_masked2 is None else tail_masked2
    qt1, qt2 = zeros(), zeros()
    if cfg.quality_trim_cutoff > 0:
        bases1, quals1, qt1 = quality_trim_device(
            bases1, quals1, cfg.quality_trim_cutoff, tm1)
        bases2, quals2, qt2 = quality_trim_device(
            bases2, quals2, cfg.quality_trim_cutoff, tm2)
    end1 = score_end(arrays, cfg, bases1, quals1)
    end2 = score_end(arrays, cfg, bases2, quals2)
    out = paired_from_ends(g, l1, l2, cfg, tls, end1, end2)
    out["qtrim_1"] = qt1
    out["qtrim_2"] = qt2
    if cfg.semialigned_clip:
        for sfx, (bb, tm, qt) in (("_1", (bases1, tm1, qt1)),
                                  ("_2", (bases2, tm2, qt2))):
            sa = semialigned_clip_device(
                arrays, cfg, bb, out["start" + sfx], out["reverse" + sfx],
                out["aligned" + sfx], tm + qt)
            out.update({k + sfx: v for k, v in sa.items()})
    return out


def paired_from_ends(g: int, l1: int, l2: int, cfg: AlignConfig,
                     tls: TlsStatic, end1: dict, end2: dict) -> dict:
    """Pair resolution and scoring from two scored end dicts."""
    log_rog_t = quality.log_rest_of_genome_correction(g, l1 + l2)
    log_rog1 = quality.log_rest_of_genome_correction(g, l1)
    log_rog2 = quality.log_rest_of_genome_correction(g, l2)

    pairs = resolve_pairs(cfg, tls, end1, end2, log_rog_t)

    def se_best(end):
        inf = _const(float("inf"), end["log_prob"].device)
        key = torch.where(end["valid"],
                          end["sw_score"].to(torch.float32) * 1e5
                          - end["log_prob"], inf)
        return torch.argmin(key, dim=1)           # first index on ties

    se1, se2 = se_best(end1), se_best(end2)
    idx1 = torch.where(pairs["resolved"], pairs["i1"], se1)
    idx2 = torch.where(pairs["resolved"], pairs["i2"], se2)

    def gate(end, idx, score):
        return torch.where(_take(end["well_anchored"], idx), score, 0)

    raw1, others1, scale1 = end_mapping_score(end1, idx1, log_rog1)
    raw2, others2, scale2 = end_mapping_score(end2, idx2, log_rog2)
    score1 = gate(end1, idx1, raw1)
    score2 = gate(end2, idx2, raw2)
    # dodgy repeats (scored-candidate overflow): forced score, optionally
    # unaligned (reference --dodgy-alignment-score)
    score1 = torch.where(end1["dodgy"], cfg.dodgy_mapq, score1)
    score2 = torch.where(end2["dodgy"], cfg.dodgy_mapq, score2)

    def end_out(end, idx, frag_score, others, scale, suffix):
        aligned = end["valid"].any(dim=1)
        if cfg.dodgy_unaligned:
            aligned = aligned & ~end["dodgy"]
        return {
            # scaled neighborhood mass + its log scale: host consumers
            # (gapped/indel polish) recover the raw f64 mass as
            # others_sum * exp(log_scale)
            f"others_sum{suffix}": others,
            f"log_scale{suffix}": scale,
            f"cand_start{suffix}": end["start"],
            f"cand_orient{suffix}": end["orient"],
            f"cand_valid{suffix}": end["valid"],
            f"cand_mismatches{suffix}": end["mismatches"],
            f"aligned{suffix}": aligned,
            f"start{suffix}": torch.where(aligned, _take(end["start"], idx), -1),
            f"reverse{suffix}": _take(end["orient"], idx) == 1,
            f"mismatches{suffix}": _take(end["mismatches"], idx),
            f"edit_distance{suffix}": _take(end["edit"], idx),
            f"log_prob{suffix}": _take(end["log_prob"], idx),
            f"frag_score{suffix}": torch.where(aligned, frag_score, 0),
            f"num_candidates{suffix}": end["num_candidates"],
        }

    out = {}
    out.update(end_out(end1, idx1, score1, others1, scale1, "_1"))
    out.update(end_out(end2, idx2, score2, others2, scale2, "_2"))
    for sfx, end in (("_1", end1), ("_2", end2)):
        for k, v in end.get("finder_stats", {}).items():
            out[f"{k}{sfx}"] = v
    out["pair_resolved"] = pairs["resolved"]
    out["pair_total_prob"] = pairs["total_prob"]
    out["pair_log_scale"] = pairs["log_scale"]
    out["pair_best_lp"] = pairs["best_lp"]
    out["proper_pair"] = pairs["proper"]
    out["template_length"] = pairs["template_length"]
    out["template_score"] = torch.where(
        end1["dodgy"] | end2["dodgy"], -1,
        torch.clamp(pairs["template_score"], -1, cfg.mapq_cap))
    # shadow rows: exactly one end aligned (the aligned end is the orphan,
    # the unaligned mate the shadow; shadow_1 == end 1 is the shadow)
    out["shadow_1"] = out["aligned_2"] & ~out["aligned_1"]
    out["shadow_2"] = out["aligned_1"] & ~out["aligned_2"]
    # disjoined rows: both ends aligned but no TLS-compatible pair; the
    # host rescues from each end (TemplateBuilder::buildDisjoinedTemplate,
    # TemplateBuilder.cpp:716-866)
    out["disjoined"] = out["aligned_1"] & out["aligned_2"] \
        & ~out["pair_resolved"]
    return out


# ---------------------------------------------------------------------------
# Shadow rescue
# ---------------------------------------------------------------------------

def mate_window_dynamic(tls: TlsStatic, read_index: int, read_lengths,
                        reverse):
    """Per-row mate-window offsets and shadow orientation
    (TemplateLengthStatistics.cpp:186-240: mateMin/MaxPosition and
    mateOrientation, the first best model matching the orphan's
    orientation winning).  `reverse` is a [Rb] bool tensor.  Returns
    (min_off, max_off, shadow_rev), offsets relative to the orphan start
    (int64 [Rb])."""
    rev = reverse.to(torch.int64)
    shift = 1 - read_index
    m0 = ((tls.best0 >> shift) & 1) == rev
    m1 = ((tls.best1 >> shift) & 1) == rev
    valid = m0 | m1
    b0 = torch.full_like(rev, tls.best0)
    chosen = torch.where(m0, b0, torch.where(m1, tls.best1, b0))
    # firstFragment: model < 4 means read 0 is leftmost
    first = (chosen < 4) == (read_index == 0)
    shadow_rev = ((chosen >> read_index) & 1) != 0
    own_len = read_lengths[read_index]
    mate_len = read_lengths[1 - read_index]

    def pick(a: int, b: int):
        return torch.where(first, torch.full_like(rev, a),
                           torch.full_like(rev, b))

    mn_off = pick(tls.mate_min - mate_len, -tls.mate_max + own_len)
    mx_off = pick(tls.mate_max - mate_len, -tls.mate_min + own_len)
    return (torch.where(valid, mn_off, 0), torch.where(valid, mx_off, 0),
            shadow_rev)


def _span_planes(arrays: IndexArrays, cfg: AlignConfig, win_start,
                 span_len: int):
    """(codes uint8, N-bits bool) [Rb, span_len] of the genome from each
    row's `win_start`, gathered from the packed planes: one contiguous word
    gather per row, funnel-shifted into phase and lane-expanded.  The
    origin is clamped to the plane's first representable position (plane
    base - GENOME_PAD), so a window hanging far off the genome start
    cannot wrap the word index, and a per-row re-phase puts the span back
    at win_start (positions below the origin read as N)."""
    rb = win_start.shape[0]
    dev = win_start.device
    origin = torch.clamp(win_start, min=arrays.plane_base - GENOME_PAD)
    rel = origin - arrays.plane_base
    gp = arrays.genome_packed
    w_span = -(-span_len // 16) + 1
    widx = torch.clamp((rel >> 4)[:, None] + GP_PAD_WORDS
                       + torch.arange(w_span, dtype=torch.int64, device=dev),
                       0, gp.shape[0] - 1)
    al_w = _funnel(gp[widx], ((origin & 15) << 1)[:, None])
    lane_shifts = 2 * (15 - torch.arange(16, dtype=torch.int64, device=dev))
    span = ((al_w[:, :, None] >> lane_shifts) & 3).reshape(
        rb, (w_span - 1) * 16)[:, :span_len].to(torch.uint8)
    if cfg.genome_has_n:
        gn = arrays.genome_nbits
        w_n = -(-span_len // 32) + 1
        nidx = torch.clamp((rel >> 5)[:, None] + GN_PAD_WORDS
                           + torch.arange(w_n, dtype=torch.int64, device=dev),
                           0, gn.shape[0] - 1)
        nal = _funnel(gn[nidx], (origin & 31)[:, None])
        nlane = 31 - torch.arange(32, dtype=torch.int64, device=dev)
        span_n = (((nal[:, :, None] >> nlane) & 1) != 0).reshape(
            rb, (w_n - 1) * 32)[:, :span_len]
    else:
        span_n = torch.zeros((rb, span_len), dtype=torch.bool, device=dev)
    # re-phase from `origin` back to win_start (d < 0 only for clamped rows)
    d = (win_start - origin)[:, None]
    k = torch.arange(span_len, dtype=torch.int64, device=dev)[None, :]
    rp = torch.clamp(k + d, 0, span_len - 1)
    return span.gather(1, rp), span_n.gather(1, rp) | (k + d < 0)


def rescue_shadows(arrays: IndexArrays, cfg: AlignConfig, tls: TlsStatic,
                   orphan_read_index: int, read_lengths: tuple[int, int],
                   orphan_start, orphan_rev, shadow_bases, shadow_quals,
                   window: int) -> dict:
    """Score the shadow read at every offset of the TLS mate window.

    Rows are host-compacted orphan rows: orphan_start/orphan_rev [Rb] (the
    orphan's best placement), shadow_bases/shadow_quals [Rb, L2];
    read_lengths is the pair geometry (read-1 length, read-2 length);
    `window` offsets are scanned (>= mate_max - mate_min + 1).  Every row
    is independent, and the [Rb, window, L2] planes are materialized, so
    callers bound Rb by memory.

    Returns found, start, reverse, mismatches, edit_distance, log_prob,
    total_prob and score (the rescued pair's score), all [Rb]."""
    rb, l2 = shadow_bases.shape
    dev = shadow_bases.device
    orphan_start = orphan_start.to(torch.int64)
    mn_off, mx_off, shadow_rev = mate_window_dynamic(
        tls, orphan_read_index, read_lengths, orphan_rev)
    win_start = orphan_start + mn_off
    win_end = orphan_start + mx_off

    seq = torch.where(shadow_rev[:, None], bitops.revcomp_reads(shadow_bases),
                      shadow_bases)
    q = torch.where(shadow_rev[:, None], bitops.reverse_quals(shadow_quals),
                    shadow_quals).to(torch.int64)

    g = genome_len_of(arrays, cfg)
    offs = torch.arange(window, dtype=torch.int64, device=dev)
    starts = win_start[:, None] + offs[None, :]                   # [Rb, W]
    pos_ok = (starts >= 0) & (starts + l2 <= g) & (starts <= win_end[:, None])

    span, span_n = _span_planes(arrays, cfg, win_start, window + l2)
    sl_idx = offs[:, None] + torch.arange(l2, dtype=torch.int64,
                                          device=dev)[None, :]  # [W, L2]
    ref = span[:, sl_idx]                                         # [Rb, W, L2]
    ref_n = span_n[:, sl_idx]
    s3 = seq[:, None, :]
    is_match = (s3 == dna.N) | ((s3 == ref) & ~ref_n)
    # float64 terms summed and rounded once (pipeline.sum_f32)
    t_match, t_mismatch = (t.to(torch.float64) for t in quality.log_tables(dev))
    lp = torch.where(is_match, t_match[q][:, None, :],
                     t_mismatch[q][:, None, :]).sum(dim=-1).to(torch.float32)
    nmm = (~is_match).sum(dim=-1).to(torch.int32)
    edit = ((s3 != ref) | (s3 == dna.N) | ref_n).sum(dim=-1).to(torch.int32)
    del ref, ref_n, is_match

    inf = _const(float("inf"), dev)
    zero = _const(0.0, dev)
    lp = torch.where(pos_ok, lp, -inf)
    key = torch.where(pos_ok, nmm.to(torch.float32) * 1e5 - lp, inf)
    best = torch.argmin(key, dim=1)               # first index on ties

    max_mm = int(l2 * cfg.rescue_max_mismatch_frac)
    found = pos_ok.any(dim=1) & (_take(nmm, best) <= max_mm)
    total_prob = torch.where(pos_ok, torch.exp(lp), zero).sum(dim=1)

    # the rescued pair's score in log space (a high-mismatch rescue's
    # exp(lp) underflows f32): with r = (sum_w exp(lp_w - m) - e_best) /
    # e_best + exp(log_rog - lp_best), score = -10*log10(r / (r + 1))
    lp_best = _take(lp, best)
    m = lp.amax(dim=1)
    m_safe = torch.where(torch.isfinite(m), m, zero)
    sum_r = torch.where(pos_ok, torch.exp(lp - m_safe[:, None]), zero).sum(dim=1)
    e_best = torch.exp(lp_best - m_safe)
    log_rog = quality.log_rest_of_genome_correction(
        int(g), read_lengths[0] + read_lengths[1])
    rog_term = torch.exp(torch.clamp(_const(log_rog, dev) - lp_best,
                                     -80.0, 80.0))
    r = torch.clamp(sum_r - e_best, min=0.0) / torch.clamp(e_best, min=1e-30) \
        + rog_term
    score_f = -10.0 * torch.log10(r / (r + 1.0))
    score_f = torch.where(torch.isfinite(score_f), score_f,
                          torch.full_like(score_f, float(cfg.mapq_cap)))
    score = torch.clamp(torch.floor(score_f), 0.0,
                        float(cfg.mapq_cap)).to(torch.int32)

    return {
        "found": found,
        "start": _take(starts, best),
        "reverse": shadow_rev,
        "mismatches": _take(nmm, best),
        "edit_distance": _take(edit, best),
        "log_prob": lp_best,
        "total_prob": total_prob,
        "score": score,
    }
