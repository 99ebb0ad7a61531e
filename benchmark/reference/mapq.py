"""The plain reference of the mapping-quality and pair models (numpy,
float64 throughout; nothing of the program is imported).

The mapping quality of an end is -10 log10 of the chance that its chosen
alignment is wrong: the probability mass of every other candidate of the
end plus the rest-of-genome prior 2 G / 4^L, over that plus the chosen
one's mass.  A candidate's mass is the product over its read bases of
P(match | quality) = 1 - 10^(-q/10), or P(mismatch) = 10^(-q/10) / 3 for
a mismatch (an N read base matches; an N genome base does not; bases
beyond the contig that holds the candidate's middle base count for
nothing).  The score is capped at -10 log10(1e-38) = 380, and floored;
the program may land anywhere in the band that float32 masses allow.

The candidates are the program's own (its seed search is the step that
the reference cannot redo); the judge checks that stage apart, as
placement against the planted truth.  Everything from there on (each
candidate's log-probability, the masses, the rest-of-genome prior, the
score) is worked out again here.
"""

from __future__ import annotations

import math

import numpy as np

MAX_Q = 100
SCORE_CAP = -10.0 * math.log10(1e-38)


def _tables() -> tuple[np.ndarray, np.ndarray]:
    q = np.arange(MAX_Q, dtype=np.float64)
    q[0] = 1.0                       # Q0 is read as Q1 for a match ...
    match = np.log1p(-10.0 ** (-q / 10.0))
    mismatch = np.log(10.0 ** (-q / 10.0) / 3.0)
    mismatch[0] = match[0]           # ... and a Q0 mismatch costs the same
    return match, mismatch


LOG_MATCH, LOG_MISMATCH = _tables()


def log_rest_of_genome(genome_length: int, read_length: int) -> float:
    return (math.log(2.0) + math.log(float(genome_length))
            - math.log(4.0) * float(read_length))


def candidate_log_probs(codes: np.ndarray, offsets: np.ndarray,
                        ends: np.ndarray, seq: np.ndarray, qual: np.ndarray,
                        starts: np.ndarray, reverse: np.ndarray) -> np.ndarray:
    """float64 log-probability of the ungapped alignment of one read (as
    sequenced) at each candidate (`starts` in genome coordinates,
    `reverse` its strand)."""
    l = seq.shape[0]
    starts = np.asarray(starts, np.int64)
    reverse = np.asarray(reverse, bool)
    rc = seq[::-1]
    rc = np.where(rc < 4, 3 - rc, rc)
    read = np.where(reverse[:, None], rc[None, :], seq[None, :])
    q = np.where(reverse[:, None], qual[::-1][None, :], qual[None, :])
    q = np.minimum(q.astype(np.int64), MAX_Q - 1)
    pos = starts[:, None] + np.arange(l)[None, :]
    c = np.clip(np.searchsorted(offsets, starts + l // 2, side="right") - 1,
                0, len(offsets) - 1)
    inside = (pos >= offsets[c][:, None]) & (pos < ends[c][:, None])
    ref = codes[np.clip(pos, 0, codes.shape[0] - 1)]
    match = (read == 4) | ((read == ref) & (ref != 4))
    terms = np.where(match, LOG_MATCH[q], LOG_MISMATCH[q])
    return np.where(inside, terms, 0.0).sum(axis=1)


#: float32's unit roundoff: the configurations keep probability masses in
#: float32, on the scale of the largest
F32_ROUNDOFF = 2.0 ** -24


def mapping_score(log_probs: np.ndarray, best: int,
                  log_rog: float) -> tuple[float, float]:
    """Unfloored score of candidate `best` among `log_probs`, as the
    lowest and highest the stated precision allows: the other
    candidates' mass is a float32 difference of the total and the best
    (both near 1 on the scale of the largest), so it may be off by the
    total's rounding, a unit roundoff for each term summed."""
    lp = np.asarray(log_probs, np.float64)
    m = lp.max()
    mass = np.exp(lp - m)
    total = mass.sum()
    p_best = mass[best]
    rog = math.exp(min(max(log_rog - m, -700.0), 700.0))
    delta = F32_ROUNDOFF * (len(lp) + 2) * total

    def score(others: float) -> float:
        nb = max(others, 0.0) + rog
        frac = nb / max(nb + p_best, 1e-300)
        return min(-10.0 * math.log10(max(frac, 1e-300)), SCORE_CAP)

    others = total - p_best
    return score(others + delta), score(others - delta)


def score_matches(program: int, scores: tuple[float, float], cap: int,
                  eps: float = 1e-3) -> bool:
    """The program's floored score against the reference's band of
    unfloored ones (`mapping_score`), all capped at `cap` (the mapping
    quality a record carries)."""
    lo = min(math.floor(scores[0] - eps), cap)
    hi = min(math.floor(scores[1] + eps), cap)
    return lo <= min(int(program), cap) <= hi


def end_mapq_check(codes, offsets, ends, genome_length: int, seq, qual,
                   cands: tuple, start: int, reverse: bool, cigar,
                   program_score: int, program_lp: float | None,
                   cap: int) -> tuple[int, float] | None:
    """(1 when the program's mapping score of one end disagrees with the
    reference's, else 0; the gap between the program's log-probability of
    the chosen alignment and the reference's, 0 without one), or None when
    the end is not judged here.

    `cands` = (starts, reverse, valid) of the end's candidates in genome
    coordinates.  An end is judged when its reported alignment is one of
    its candidates, ungapped and unclipped (a gapped polish or a rescue
    moves it off the candidates: the judge's placement check covers
    those).  A score of 0 is the program's gate for an end that no
    unique seed anchors, and always agrees."""
    l = seq.shape[0]
    if cigar not in (None, "", f"{l}M"):
        return None
    c_start, c_rev, c_valid = (np.asarray(x) for x in cands)
    c_valid = c_valid.astype(bool)
    c_start, c_rev = c_start[c_valid], c_rev[c_valid].astype(bool)
    hit = np.nonzero((c_start == start) & (c_rev == reverse))[0]
    if hit.size == 0:
        return None
    lps = candidate_log_probs(codes, offsets, ends, seq, qual, c_start, c_rev)
    best = int(hit[0])
    gap = 0.0 if program_lp is None else abs(float(program_lp) - lps[best])
    if int(program_score) == 0:
        return 0, gap
    score = mapping_score(lps, best, log_rest_of_genome(genome_length, l))
    return int(not score_matches(program_score, score, cap)), gap


def template_length(pos_a: int, span_a: int, pos_b: int, span_b: int) -> int:
    """Template length of two ends on one contig: from the leftmost start
    to the rightmost end, at least either end's span."""
    if pos_a <= pos_b:
        return max(pos_b + span_b - pos_a, span_a)
    return max(pos_a + span_a - pos_b, span_b)


def proper_expected(same_contig: bool, rev_a: bool, pos_a: int, span_a: int,
                    rev_b: bool, pos_b: int, span_b: int,
                    nominal: tuple[int, int], far: int) -> bool | None:
    """What the pair model must say of two aligned ends whose placement
    the judge found right: True for a forward-reverse pair (the forward
    end leftmost) whose template length lies well inside the library's
    insert distribution (`nominal`, a range that every template-length
    model learned from it holds), False for ends on two contigs or at
    least `far` bases apart; None between, where the learned model's
    bounds decide."""
    if not same_contig:
        return False
    length = template_length(pos_a, span_a, pos_b, span_b)
    if length >= far:
        return False
    fr = rev_a != rev_b and ((pos_a <= pos_b) != rev_a
                             if pos_a != pos_b else True)
    if fr and nominal[0] <= length <= nominal[1]:
        return True
    return None
