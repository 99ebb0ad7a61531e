"""Alignment-quality math on tensors: log-prob tables and MAPQ.

Port of `isaac_aligner_tpu/align/quality.py` (see its docstring for the
reference parity targets).  The tables are built in numpy float64 exactly
as there and used as float32 on the device; the MAPQ math runs on
exp(-m)-scaled masses so float32 never underflows.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

MAX_Q = 100


def _log_match_table() -> np.ndarray:
    t = np.empty(MAX_Q, dtype=np.float64)
    t[0] = np.log(1.0 - 10.0 ** (-0.1))
    for q in range(1, MAX_Q):
        t[q] = np.log(1.0 - 10.0 ** (-q / 10.0))
    return t


def _log_mismatch_table() -> np.ndarray:
    t = np.empty(MAX_Q, dtype=np.float64)
    t[0] = np.log(1.0 - 10.0 ** (-0.1))  # sic — the reference's Q0 entry
    for q in range(1, MAX_Q):
        t[q] = np.log(10.0 ** (-q / 10.0) / 3.0)
    return t


LOG_MATCH_F64 = _log_match_table()
LOG_MISMATCH_F64 = _log_mismatch_table()
LOG_MATCH_NP = LOG_MATCH_F64.astype(np.float32)
LOG_MISMATCH_NP = LOG_MISMATCH_F64.astype(np.float32)


def log_tables(device) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 (log match, log mismatch) tables on `device`, uploaded once
    per device: a copy from pageable host memory may wait for the device's
    queue, which would stall every caller behind the device's work."""
    return _tables_on(torch.device(device))


@functools.lru_cache(maxsize=None)
def _tables_on(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.from_numpy(LOG_MATCH_NP).to(device),
            torch.from_numpy(LOG_MISMATCH_NP).to(device))


def log_tables_f64(device) -> tuple[torch.Tensor, torch.Tensor]:
    """float64 (log match, log mismatch) tables on `device`, uploaded once
    per device (the gapped polish's rescore on the card, `ops.sw.sw_walk`)."""
    return _f64_tables_on(torch.device(device))


@functools.lru_cache(maxsize=None)
def _f64_tables_on(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.from_numpy(LOG_MATCH_F64).to(device),
            torch.from_numpy(LOG_MISMATCH_F64).to(device))


def rest_of_genome_correction(genome_length: int, read_length: int) -> float:
    """P(best alignment is elsewhere in the genome) prior: 2*G/4^L."""
    return float(np.exp(np.log(2.0) + np.log(float(genome_length))
                        - np.log(4.0) * float(read_length)))


def log_rest_of_genome_correction(genome_length: int, read_length: int) -> float:
    """ln of the rest-of-genome prior (2*G/4^L underflows f32)."""
    return float(np.log(2.0) + np.log(float(genome_length))
                 - np.log(4.0) * float(read_length))


def mapping_quality_f64(best_log_prob, others_prob_sum, rog_correction):
    """Host float64 MAPQ (numpy end to end; the cross-group merge of
    `parallel/multi_index.py` re-derives it from summed masses):
    -10 log10(neighborhood / (neighborhood + exp(best_lp)))."""
    nb = np.asarray(rog_correction, np.float64) \
        + np.asarray(others_prob_sum, np.float64)
    p_best = np.exp(np.asarray(best_log_prob, np.float64))
    with np.errstate(divide="ignore", invalid="ignore"):
        frac = nb / (nb + p_best)
        out = -10.0 * np.log10(np.maximum(frac, 1e-300))
    # nb == p_best == 0 (no mass at all) -> maximal confidence is wrong;
    # callers gate on aligned, return 0 for definiteness
    return np.where(np.isfinite(out), out, 0.0)


def scaled_masses(lp, valid, best_lp):
    """(total_scaled, p_best_scaled, m_safe): probability masses scaled
    by exp(-m), m = per-row max of the valid log probs (last axis)."""
    neg_inf = torch.full((), -float("inf"), dtype=lp.dtype, device=lp.device)
    m = torch.where(valid, lp, neg_inf).amax(dim=-1)
    finite_m = torch.isfinite(m)
    m_safe = torch.where(finite_m, m, torch.zeros_like(m))
    total = torch.where(valid, torch.exp(lp - m_safe[..., None]),
                        torch.zeros_like(lp)).sum(dim=-1)
    p_best = torch.where(torch.isfinite(best_lp) & finite_m,
                         torch.exp(best_lp - m_safe), torch.zeros_like(best_lp))
    return total, p_best, m_safe


def rog_scaled(log_rog: float, m_safe):
    """The rest-of-genome prior on the exp(-m) scale, exponent clipped to
    the f32-representable band."""
    log_rog_f32 = torch.full((), log_rog, dtype=torch.float32,
                             device=m_safe.device)
    return torch.exp(torch.clamp(log_rog_f32 - m_safe, -87.0, 88.0))


def mapping_quality_scaled(total_scaled, p_best_scaled, rog_s):
    """-10*log10(neighborhood / (neighborhood + best)) over exp(-m)-scaled
    masses (the scale cancels in the ratio)."""
    nb = torch.clamp(total_scaled - p_best_scaled, min=0.0) + rog_s
    frac = nb / torch.clamp(nb + p_best_scaled, min=1e-38)
    return -10.0 * torch.log10(torch.clamp(frac, min=1e-38))
