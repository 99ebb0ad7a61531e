"""Gapped-alignment polish: re-align poor ungapped hits with banded SW.

Port of `isaac_aligner_tpu/align/gapped.py` (reference GappedAligner,
GappedAligner.cpp:167-253).  Rows whose ungapped alignment shows more than
`trigger` mismatches are re-aligned over a window of read_len + 15
reference bases (flanks split 7/8); the gapped result replaces the
ungapped one when its normalized score is better.

Every triggered chunk goes to `ops.sw.banded_sw` on the aligner's device,
and its traceback walk and rescore to `ops.sw.sw_walk` on the same device:
the CUDA kernels on a card, their plain versions on the CPU.  The JAX
package's HOST_DP_MAX threshold (small chunks on the host numpy DP) was
sized for the TPU link's round trip and is dropped; the results are the
same either way, since all versions are bit-identical.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..index.build import SeedIndex
from ..io.bam import parse_cigar
from ..ops import sw
from ..utils import tracing
from . import quality
from .pipeline import AlignConfig

#: ungapped mismatch count that triggers gap alignment
#: (BandedSmithWaterman.hh:94 mismatchesCutoff)
MISMATCHES_CUTOFF = 5


@dataclasses.dataclass(frozen=True)
class GapScoring:
    """--gap-scoring parameters (presets bwa = 0:-3:-11:-4:-20,
    eland = 2:-1:-15:-3:-25).  Normalization follows AlignerBase.cpp:38-41:
    normalized X = match - X, max gap extend = -min_extend."""

    match: float = 0.0
    mismatch: float = -3.0
    open: float = -11.0
    extend: float = -4.0
    min_extend: float = -20.0

    @property
    def norm_mismatch(self) -> int:
        return int(self.match - self.mismatch)

    @property
    def norm_open(self) -> int:
        return int(self.match - self.open)

    @property
    def norm_extend(self) -> int:
        return int(self.match - self.extend)

    @property
    def norm_max_extend(self) -> int:
        return int(-self.min_extend)

    def norms(self) -> tuple[int, int, int, int]:
        """(mismatch, open, extend, max extend) normalized, for ops.sw."""
        return (self.norm_mismatch, self.norm_open, self.norm_extend,
                self.norm_max_extend)

    def sw_scores(self) -> tuple[float, float, float, float]:
        """(match, mismatch, open, extend) for ops.sw."""
        return (self.match, self.mismatch, self.open, self.extend)

    @staticmethod
    def parse(spec: str) -> "GapScoring":
        if spec == "bwa":
            return BWA
        if spec == "eland":
            return ELAND
        parts = [float(x) for x in spec.split(":")]
        if len(parts) not in (4, 5):
            raise ValueError(
                f"--gap-scoring {spec!r}: want bwa, eland or m:mm:go:ge[:me]")
        if len(parts) == 4:
            parts.append(-20.0)
        return GapScoring(*parts)


BWA = GapScoring()
ELAND = GapScoring(2.0, -1.0, -15.0, -3.0, -25.0)

# module-level defaults for callers that do not thread a GapScoring (the
# Build phase's known-gap realignment, build/realign.py)
NORM_MISMATCH = BWA.norm_mismatch
NORM_OPEN = BWA.norm_open
NORM_EXTEND = BWA.norm_extend
NORM_MAX_EXTEND = BWA.norm_max_extend


def _flanks(local_pos: int, read_len: int, contig_len: int) -> tuple[int, int] | None:
    """Left/right reference flanks summing to BAND-1 (getFlanks)."""
    total = sw.BAND - 1
    left = min(7, local_pos)
    right = total - left
    if local_pos + read_len + right > contig_len:
        right = contig_len - local_pos - read_len
        left = total - right
        if right < 0 or left > local_pos:
            return None
    return left, right


def cigar_stats(cigar: list[tuple[int, str]], gs: GapScoring = BWA):
    """(observed_ref_length, gap_bases, gap_count, normalized_gap_score)."""
    obs = 0
    gap_bases = 0
    gap_count = 0
    norm = 0
    for length, op in cigar:
        if op in ("M", "D"):
            obs += length
        if op in ("I", "D"):
            gap_bases += length
            gap_count += 1
            norm += gs.norm_open + min(gs.norm_max_extend,
                                       (length - 1) * gs.norm_extend)
    return obs, gap_bases, gap_count, norm


def rescore_cigar(genome_codes, start, seq, quals, cigar,
                  gs: GapScoring = BWA):
    """Reference updateFragmentCigar over an explicit CIGAR (host, f64).

    Returns (log_prob, scoring_mismatches, edit_distance, norm_score).
    """
    lp = 0.0
    nmm = 0
    edit = 0
    norm = 0
    qpos = 0
    rpos = int(start)
    for length, op in cigar:
        if op == "M":
            for _ in range(length):
                s = int(seq[qpos]); r = int(genome_codes[rpos]); q = int(quals[qpos])
                is_match = (s == 4) or (s == r and r != 4)
                if is_match:
                    lp += quality.LOG_MATCH_F64[q]
                else:
                    lp += quality.LOG_MISMATCH_F64[q]
                    nmm += 1
                    norm += gs.norm_mismatch
                if s != r or s == 4:
                    edit += 1
                qpos += 1
                rpos += 1
        elif op == "I":
            qpos += length
            edit += length
            norm += gs.norm_open + min(gs.norm_max_extend,
                                       (length - 1) * gs.norm_extend)
        elif op == "D":
            rpos += length
            edit += length
            norm += gs.norm_open + min(gs.norm_max_extend,
                                       (length - 1) * gs.norm_extend)
        elif op == "S":
            for _ in range(length):
                lp += quality.LOG_MATCH_F64[int(quals[qpos])]
                qpos += 1
    return lp, nmm, edit, norm


#: makes_sense_to_gap_align constants (GappedAligner.hh:59,75)
_HASH_K = 7
_SUFFICIENT_HITS = 8


def makes_sense_to_gap_align(q: np.ndarray, db: np.ndarray,
                             k: int = _HASH_K,
                             sufficient: int = _SUFFICIENT_HITS) -> bool:
    """Reference GappedAligner::makesSenseToGapAlign: SW can only improve
    the alignment when two distinct query-vs-database shifts each collect
    `sufficient` unique k-mer votes (evidence of a gap)."""
    if len(q) < k or len(db) < k:
        return False
    w = (4 ** np.arange(k - 1, -1, -1)).astype(np.int64)
    qwin = np.lib.stride_tricks.sliding_window_view(q, k)
    dwin = np.lib.stride_tricks.sliding_window_view(db, k)
    q_n = (qwin >= 4).any(axis=1)
    d_n = (dwin >= 4).any(axis=1)
    qk = (np.minimum(qwin, 3).astype(np.int64) * w).sum(axis=1)
    dk = (dwin.astype(np.int64) * w).sum(axis=1)
    # unique query offset per k-mer; repeats poison the entry (-2)
    offsets = np.full(4 ** k, -1, np.int64)
    for i in np.nonzero(~q_n)[0]:
        key = qk[i]
        offsets[key] = i if offsets[key] == -1 else -2
    qoff = offsets[dk]
    ok = (qoff >= 0) & ~d_n
    if not ok.any():
        return False
    shifts = np.nonzero(ok)[0] - qoff[ok]
    counts = np.bincount(shifts - shifts.min())
    return int((counts >= sufficient).sum()) >= 2


def _soft_clip_query(cigar: list[tuple[int, str]], t: int, at_end: bool):
    """Soft-clip the first (or, `at_end`, the last) `t` query bases of a
    walk's CIGAR (M, I, D runs); a gap left at the clip's edge goes with
    it (an insertion into the clip).  Returns (CIGAR, reference bases the
    clip took from the alignment's side, offsets from the clipped end of
    the inserted bases it took), the start moving by the second when the
    clip leads."""
    ops = list(reversed(cigar)) if at_end else list(cigar)
    ref, left, k, q = 0, t, 0, 0
    ins: list[int] = []
    while left > 0:
        n, op = ops[k]
        if op == "D":
            ref += n
            k += 1
            continue
        use = min(n, left)
        left -= use
        if op == "M":
            ref += use
        else:
            ins.extend(range(q, q + use))
        q += use
        if use < n:
            ops[k] = (n - use, op)
        else:
            k += 1
    rest = ops[k:]
    while rest and rest[0][1] in "ID":
        n, op = rest.pop(0)
        if op == "I":
            ins.extend(range(q, q + n))
            q += n
            t += n
        else:
            ref += n
    out = [(t, "S")] + rest
    return (out[::-1] if at_end else out), ref, ins


def _m_bases(cigar) -> int:
    return sum(n for n, op in cigar if op == "M")


def polish_gapped(index: SeedIndex, cfg: AlignConfig, res: dict,
                  bases: np.ndarray, device, suffix: str = "",
                  trigger: int = MISMATCHES_CUTOFF,
                  quals: np.ndarray | None = None,
                  gs: GapScoring = BWA, avoid_sw: bool = False, *,
                  tally, masked: np.ndarray | None = None,
                  accepted: list | None = None) -> int:
    """Re-align triggered rows with banded SW on `device`; mutate `res`.

    res must carry (with `suffix`): aligned, start, reverse, mismatches,
    edit_distance, log_prob.  Adds/updates `cigar{suffix}` (list of
    per-row CIGAR strings, None for the default full-M).  Returns the
    number of (query, window) pairs scored by `sw.banded_sw`, and adds
    those whose gapped result replaced the ungapped one to
    `tally.sw_accepted` (the aligner's counter).

    `sw.sw_walk` walks and rescores every pair where `banded_sw` left its
    outputs (on a card, in a kernel), so the host only takes the accepted
    rows' results.

    `masked` (per row, the masked tail whose soft clip
    `clippers.apply_masked_tail_cigar` wrote as its CIGAR, 0 elsewhere)
    lets such a row through: its whole oriented read
    goes to the kernel from its unclipped start, the masked bases N there,
    and a walk it takes keeps the masked bases soft-clipped and is taken by
    the same rule when a gap stays in the aligned part.  Its fields are
    the walk's less what the clip took (`rescore_cigar`'s of the clipped
    CIGAR: the masked bases are N, so none was a mismatch, each an edit,
    and a soft clip's log-probability is its bases' match terms, which an
    insertion's bases lacked).  Every other row with a CIGAR is left as
    it is.  `accepted`, when given, gets the rows whose alignment was
    replaced.
    """
    s = suffix
    genome = index.genome
    aligned = res["aligned" + s]
    nmm = res["mismatches" + s]
    rows = np.nonzero(aligned & (nmm > trigger))[0]
    key = "cigar" + s
    if key not in res:
        res[key] = [None] * aligned.shape[0]
    if rows.size == 0:
        return 0

    read_len = bases.shape[1]
    g_codes = genome.codes
    queries = []
    dbs = []
    metas = []
    with tracing.span("polish.gapped.windows"):
        for r in rows:
            t = 0
            if res[key][r] is not None:
                t = int(masked[r]) if masked is not None else 0
                if t <= 0:
                    continue  # another clip (contig end) stays as it is
            start = int(res["start" + s][r])
            if t and res["reverse" + s][r]:
                start -= t    # the masked tail's lead clip moved it
            contig = genome.contig_of(start)
            local = start - contig.offset
            fl = _flanks(local, read_len, contig.length)
            if fl is None:
                continue
            left, _right = fl
            win_start = start - left
            db = g_codes[win_start : win_start + read_len + sw.BAND - 1]
            if res["reverse" + s][r]:
                q = bases[r][::-1]
                q = np.where(q < 4, 3 - q, q)
            else:
                q = bases[r]
            q = q.astype(np.int32)
            db = db.astype(np.int32)
            if avoid_sw and not makes_sense_to_gap_align(q, db):
                continue  # --avoid-smith-waterman: no gap evidence
            queries.append(q)
            dbs.append(db)
            metas.append((int(r), win_start, t))
    if not metas:
        return 0

    if quals is None:
        quals = np.full_like(bases, 30)
    rk, win_starts, tk = (np.array(col, np.int64) for col in zip(*metas))

    with tracing.span("polish.gapped.kernel"):
        # oriented qualities, reversed with their reads
        rq = quals[rk].astype(np.uint8)
        rev = res["reverse" + s][rk].astype(bool)
        rq[rev] = rq[rev, ::-1]
        q_dev = torch.from_numpy(np.stack(queries).astype(np.uint8)).to(device)
        db_dev = torch.from_numpy(np.stack(dbs).astype(np.uint8)).to(device)
        ql_dev = torch.from_numpy(rq).to(device)
        gfin, tb = sw.banded_sw(q_dev, db_dev, gs.sw_scores())
        walks = sw.sw_walk(gfin, tb, q_dev, db_dev, ql_dev,
                           *quality.log_tables_f64(device),
                           gs.norms()).cpu().numpy()
    with tracing.span("polish.gapped.traceback"):
        w = sw.decode_walk(walks)
        if (w["flags"] & sw.WALK_BAD).any():
            bad = rk[(w["flags"] & sw.WALK_BAD) != 0]
            raise ValueError(f"sw_walk: rows {bad[:8].tolist()} left the band "
                             f"or carry a quality >= {quality.MAX_Q}")
        # FragmentBuilder acceptance, of walks that found a gap: strictly
        # better normalized score, or equal score with higher log probability
        norm_g = w["norm"]
        norm_u = res["mismatches" + s][rk].astype(np.int64) * gs.norm_mismatch
        lp = w["log_prob"]
        take = ((w["flags"] & sw.WALK_GAPPED) != 0) & (
            (norm_g < norm_u)
            | ((norm_g == norm_u) & (lp > res["log_prob" + s][rk])))
        cigars = {kk: sw.walk_cigar(walks[kk])
                  for kk in np.nonzero(take)[0].tolist()}
        starts = win_starts + w["first_db"]
        nmm_g, edit_g = w["mismatches"].copy(), w["edit"].copy()
        lp = lp.copy()
        for kk in np.nonzero(take & (tk > 0))[0].tolist():
            r = int(rk[kk])
            rev = bool(res["reverse" + s][r])
            walk = parse_cigar(cigars[kk])
            cigar, ref_cut, ins = _soft_clip_query(walk, int(tk[kk]),
                                                   at_end=not rev)
            if not any(op in "ID" for _n, op in cigar):
                take[kk] = False   # the gap lay in the masked bases
                continue
            _o, gaps_w, _c, norm_w = cigar_stats(walk, gs)
            _o, gaps_c, _c, norm_c = cigar_stats(cigar, gs)
            norm_c = int(w["norm"][kk]) - (norm_w - norm_c)
            ql = rq[kk][::-1] if not rev else rq[kk]
            lp_c = float(lp[kk]) + float(
                quality.LOG_MATCH_F64[ql[ins]].sum()) if ins else lp[kk]
            if not (norm_c < norm_u[kk] or (norm_c == norm_u[kk] and lp_c
                                            > res["log_prob" + s][r])):
                take[kk] = False
                continue
            cigars[kk] = "".join(f"{n}{op}" for n, op in cigar)
            starts[kk] += ref_cut if rev else 0
            edit_g[kk] -= _m_bases(walk) - _m_bases(cigar) + gaps_w - gaps_c
            lp[kk] = lp_c
        k = np.nonzero(take)[0]
        r = rk[k]
        lp = lp[k]
        res["start" + s][r] = starts[k]
        res["mismatches" + s][r] = nmm_g[k]
        res["edit_distance" + s][r] = edit_g[k]
        res["log_prob" + s][r] = lp
        for kk, rr in zip(k.tolist(), r.tolist()):
            res[key][rr] = cigars[kk]
        # re-derive the mapping score with the improved best lp against the
        # (ungapped) neighborhood mass, exported exp(-log_scale)-scaled
        if "others_sum" + s in res and k.size:
            rog = quality.rest_of_genome_correction(genome.total_length,
                                                    read_len)
            scale = (res["log_scale" + s][r].astype(np.float64)
                     if "log_scale" + s in res else 0.0)
            nb = res["others_sum" + s][r].astype(np.float64) * np.exp(scale) \
                + rog
            score = np.floor(-10.0 * np.log10(nb / (nb + np.exp(lp)))
                             ).astype(np.int64)
            if "mapq" + s in res:
                res["mapq" + s][r] = np.minimum(score, cfg.mapq_cap)
            if "frag_score" + s in res:
                res["frag_score" + s][r] = score
    tally.sw_accepted += int(k.size)
    if accepted is not None:
        accepted.extend(r.tolist())
    return len(metas)
