"""Long-indel detection from disagreeing seed anchors (host numpy).

Port of `isaac_aligner_tpu/align/indel.py` (reference SimpleIndelAligner,
semialignedGapLimit=100).  A read with one indel wider than the SW band
anchors its head and tail seeds on two diagonals; both arrive in the
candidate list, and this pass pairs same-orientation candidates whose
diagonals differ by <= max_gap, finds the split point minimizing total
mismatches with two prefix sums, and accepts the two-segment CIGAR under
the banded aligner's normalized gap scoring.  The port keeps the full
[B, C] candidate planes on the result, so there is no compacted-row map.
"""

from __future__ import annotations

import numpy as np

from .. import dna
from ..index.build import SeedIndex
from ..io.bam import parse_cigar
from . import quality
from .gapped import BWA, GapScoring, cigar_stats, rescore_cigar
from .pipeline import AlignConfig

MAX_GAP = 100          # reference semialignedGapLimit
MIN_FLANK = 16         # minimum anchored bases on each side of the gap


def _mm_profile(genome: np.ndarray, start: int, seq: np.ndarray) -> np.ndarray:
    """Per-base scoring-mismatch profile of seq aligned at start."""
    l = seq.shape[0]
    g = genome.shape[0]
    if start < 0 or start + l > g:
        return np.ones(l, bool)
    ref = genome[start : start + l]
    return ~((seq == dna.N) | ((seq == ref) & (ref != dna.N)))


def polish_simple_indels(index: SeedIndex, cfg: AlignConfig, res: dict,
                         bases: np.ndarray, suffix: str = "",
                         trigger: int = 6,
                         quals: np.ndarray | None = None,
                         gs: GapScoring = BWA,
                         max_gap: int = MAX_GAP) -> np.ndarray:
    """Detect single long indels for rows still poorly aligned; mutate res.

    Runs after the banded-SW polish: rows whose best alignment still has
    > trigger mismatches and no gapped CIGAR are examined.  `max_gap` is
    the reference --semialigned-gap-limit (0 disables).  Returns the rows
    it realigned (int64, ascending): their start, strand and CIGAR may
    differ from what the pair step chose, so a paired caller works the
    pair's fields out again (`PairedAligner._repair_pairs`).
    """
    none = np.zeros(0, np.int64)
    if max_gap <= 0:
        return none
    s = suffix
    aligned = res["aligned" + s]
    key = "cigar" + s
    if key not in res:
        res[key] = [None] * aligned.shape[0]
    cand_start = res["cand_start" + s]
    cand_orient = res["cand_orient" + s]
    cand_valid = res["cand_valid" + s]
    rows = np.nonzero(aligned & (res["mismatches" + s] > trigger))[0]
    if rows.size == 0:
        return none
    moved = []
    genome = index.genome.codes
    read_len = bases.shape[1]
    if quals is None:
        quals = np.full_like(bases, 30)

    for r in rows:
        cur_cigar = res[key][r]
        if cur_cigar is not None and "S" in cur_cigar:
            continue  # masked-tail rows keep their clip info
        valid = np.nonzero(cand_valid[r])[0]
        if valid.size < 2:
            continue
        best_choice = None   # (norm, cigar, pos, orient)
        # compete against the current alignment (ungapped or banded-SW)
        # on the same normalized score
        cur_norm = int(res["mismatches" + s][r]) * gs.norm_mismatch
        if cur_cigar is not None:
            cur_norm += cigar_stats(parse_cigar(cur_cigar), gs)[3]
        for oi in (0, 1):
            cands = [int(cand_start[r, k]) for k in valid
                     if int(cand_orient[r, k]) == oi]
            if len(cands) < 2:
                continue
            seq = bases[r]
            if oi == 1:
                seq = dna.revcomp(seq)
            profiles = {c: None for c in cands}
            for a in range(len(cands)):
                for b in range(len(cands)):
                    s1, s2 = cands[a], cands[b]
                    gap = s2 - s1
                    if gap == 0 or abs(gap) > max_gap:
                        continue
                    if profiles[s1] is None:
                        profiles[s1] = _mm_profile(genome, s1, seq)
                    if profiles[s2] is None:
                        profiles[s2] = _mm_profile(genome, s2, seq)
                    mm1, mm2 = profiles[s1], profiles[s2]
                    pre = np.concatenate([[0], np.cumsum(mm1)])
                    suf = np.concatenate([np.cumsum(mm2[::-1])[::-1], [0]])
                    if gap > 0:
                        # deletion of `gap` ref bases after read offset j
                        j_lo, j_hi = MIN_FLANK, read_len - MIN_FLANK
                        if j_lo >= j_hi:
                            continue
                        tot = pre[j_lo:j_hi] + suf[j_lo:j_hi]
                        j = j_lo + int(np.argmin(tot))
                        nmm = int(tot[j - j_lo])
                        cigar = f"{j}M{gap}D{read_len - j}M"
                        glen = gap
                    else:
                        # insertion: read[j:j+ins] unaligned, tail via mm2
                        ins = -gap
                        j_lo = MIN_FLANK
                        j_hi = read_len - ins - MIN_FLANK
                        if j_lo >= j_hi:
                            continue
                        tot = pre[j_lo:j_hi] + suf[j_lo + ins : j_hi + ins]
                        j = j_lo + int(np.argmin(tot))
                        nmm = int(tot[j - j_lo])
                        cigar = f"{j}M{ins}I{read_len - j - ins}M"
                        glen = ins
                    norm = nmm * gs.norm_mismatch + gs.norm_open + \
                        min(gs.norm_max_extend, (glen - 1) * gs.norm_extend)
                    if norm < cur_norm and (best_choice is None or
                                            norm < best_choice[0]):
                        best_choice = (norm, cigar, s1, oi)
        if best_choice is None:
            continue
        _norm, cigar_str, pos, oi = best_choice
        seq = dna.revcomp(bases[r]) if oi else bases[r]
        rq = quals[r][::-1] if oi else quals[r]
        lp, nmm_g, edit_g, _ = rescore_cigar(genome, pos, seq, rq,
                                             parse_cigar(cigar_str), gs)
        res["start" + s][r] = pos
        res["reverse" + s][r] = bool(oi)
        res["mismatches" + s][r] = nmm_g
        res["edit_distance" + s][r] = edit_g
        res["log_prob" + s][r] = lp
        res[key][r] = cigar_str
        moved.append(int(r))
        if "others_sum" + s in res:
            rog = quality.rest_of_genome_correction(index.genome.total_length,
                                                    read_len)
            scale = float(res["log_scale" + s][r]) \
                if "log_scale" + s in res else 0.0
            nb = float(res["others_sum" + s][r]) * np.exp(scale) + rog
            score = int(np.floor(-10.0 * np.log10(nb / (nb + np.exp(lp)))))
            if "mapq" + s in res:
                res["mapq" + s][r] = min(score, cfg.mapq_cap)
            if "frag_score" + s in res:
                res["frag_score" + s][r] = score
    return np.asarray(moved, np.int64)
