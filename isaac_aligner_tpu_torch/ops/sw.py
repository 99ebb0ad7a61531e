"""Banded Smith-Waterman: the hand-written CUDA kernels, their plain torch
versions and the host traceback helpers.

Port of `isaac_aligner_tpu/ops/sw.py`, whose Pallas TPU kernel `_sw_body`
(launched by `banded_sw`, pl.pallas_call at sw.py:237) becomes
`csrc/banded_sw.cu` here.  Band coordinates, recurrences, tie order and
the packed traceback layout are unchanged (see that module's docstring):
cell (i, d) aligns query base i with window base i + d, d in [0, 16); the
traceback code TG + 4*TE + 16*TF packs 6 bits per row, TB_PACK rows per
int32 word.

`banded_sw` dispatches on the tensors' device: CPU tensors run
`banded_sw_torch`, a direct transcription of the numpy oracle
`banded_sw_numpy_batch`; CUDA tensors launch the kernel or raise.  It
never falls back from one to the other.

`sw_walk` takes `banded_sw`'s outputs where they lie and walks each pair's
traceback, then rescores the walks that hold a gap (`csrc/sw_walk.cu`, which
replaces no TPU kernel: the JAX package walks on the host).  The caller
gives the quality tables and the normalized gap scores, so this module
knows no scoring rule of its own.  Its plain version walks with
`traceback` and `ops_to_cigar` per pair; the same dispatch rule holds.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

BAND = 16
NEG = -1.0e9
#: query rows packed per traceback word (6 bits of state codes per row)
TB_PACK = 5
#: longest query the CUDA kernel takes (its shared-memory stage grows with
#: L; csrc/banded_sw.cu MAX_L)
MAX_LEN = 1024

# the reference's --gap-scoring presets (match, mismatch, open, extend)
BWA_SCORES = (0.0, -3.0, -11.0, -4.0)
ELAND_SCORES = (2.0, -1.0, -15.0, -3.0)


def _pick3(a, b, c):
    """State preference on ties G > E > F: 1 if b wins, 2 if c, else 0."""
    return torch.where(b > torch.maximum(a, c), 1,
                       torch.where(c > a, 2, 0)).to(torch.int32)


def banded_sw_torch(query: torch.Tensor, db: torch.Tensor,
                    scores=BWA_SCORES):
    """Plain torch banded SW on any device: query [N, L], db [N, L+15]
    integer codes -> (gfin f32 [N, BAND], tb int32 [N, ceil(L/5), BAND]).

    Elementwise f32 ops in the order of `banded_sw_numpy_batch`, so the
    result is bit-identical to it (and to the CUDA kernel)."""
    match_s, mismatch_s, open_s, extend_s = (
        torch.tensor(s, dtype=torch.float32, device=query.device)
        for s in scores)
    n, l = query.shape
    dev = query.device
    neg = torch.tensor(NEG, dtype=torch.float32, device=dev)
    q = query.to(torch.int32)
    dbi = db.to(torch.int32)
    g = torch.zeros((n, BAND), dtype=torch.float32, device=dev)
    e = torch.full((n, BAND), NEG, dtype=torch.float32, device=dev)
    f = torch.full((n, BAND), NEG, dtype=torch.float32, device=dev)
    codes = torch.zeros((n, l, BAND), dtype=torch.int32, device=dev)
    up_fill = torch.full((n, 1), NEG, dtype=torch.float32, device=dev)

    def up(x):
        return torch.cat([x[:, 1:], up_fill], dim=1)

    for i in range(l):
        q_i = q[:, i : i + 1]
        w = torch.where((q_i == dbi[:, i : i + BAND]) & (q_i < 4),
                        match_s, mismatch_s)
        m_prev = torch.maximum(torch.maximum(g, e), f)
        tg = _pick3(g, e, f)
        new_g = m_prev + w
        fg, fe, ff = up(g) + open_s, up(e) + open_s, up(f) + extend_s
        new_f = torch.maximum(torch.maximum(fg, fe), ff)
        tf = _pick3(fg, fe, ff)
        new_e = [neg.expand(n)]
        te = [torch.zeros(n, dtype=torch.int32, device=dev)]
        for d in range(1, BAND):
            fg2 = new_g[:, d - 1] + open_s
            ff2 = new_f[:, d - 1] + open_s
            fe2 = new_e[d - 1] + extend_s
            new_e.append(torch.maximum(torch.maximum(fg2, ff2), fe2))
            te.append(_pick3(fg2, fe2, ff2))
        new_e = torch.stack(new_e, dim=1)
        codes[:, i] = tg + torch.stack(te, dim=1) * 4 + tf * 16
        g, e, f = new_g, new_e, new_f

    groups = -(-l // TB_PACK)
    pad = groups * TB_PACK - l
    if pad:
        codes = torch.cat(
            [codes, torch.zeros((n, pad, BAND), dtype=torch.int32, device=dev)],
            dim=1)
    codes = codes.reshape(n, groups, TB_PACK, BAND)
    tb = codes[:, :, 0]
    for k in range(1, TB_PACK):
        tb = tb | (codes[:, :, k] << (6 * k))
    return g, tb


@functools.cache
def _launcher():
    """The C launcher of csrc/banded_sw.cu (built on first call), typed."""
    from ._build import load_kernel

    lib = load_kernel("banded_sw")
    lib.banded_sw_max_len.argtypes = []
    lib.banded_sw_max_len.restype = ctypes.c_int
    if lib.banded_sw_max_len() != MAX_LEN:
        raise RuntimeError(f"csrc/banded_sw.cu takes L <= "
                           f"{lib.banded_sw_max_len()}, sw.MAX_LEN is {MAX_LEN}")
    fn = lib.banded_sw_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_float, ctypes.c_float,
                   ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch_cuda(query: torch.Tensor, db: torch.Tensor, scores):
    """Launch the kernel on the pair-major inputs; it writes the public
    layout itself, so nothing is transposed or copied (int32 codes, which
    the gapped polish never sends, are narrowed to bytes first)."""
    n, l = query.shape
    if l > MAX_LEN:
        raise ValueError(f"banded_sw kernel takes L <= {MAX_LEN}, got {l}")
    fn = _launcher()
    dev = query.device
    q8 = query if query.dtype == torch.uint8 else query.to(torch.uint8)
    db8 = db if db.dtype == torch.uint8 else db.to(torch.uint8)
    gfin = torch.empty((n, BAND), dtype=torch.float32, device=dev)
    tb = torch.empty((n, -(-l // TB_PACK), BAND), dtype=torch.int32, device=dev)
    # the .so launches through the CUDA runtime's current device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q8.data_ptr(), db8.data_ptr(), n, l,
                *(float(s) for s in scores), gfin.data_ptr(), tb.data_ptr(),
                stream)
    if rc != 0:
        raise RuntimeError(f"banded_sw kernel launch failed: CUDA error {rc}")
    banded_sw.launches += 1
    return gfin, tb


def banded_sw(query: torch.Tensor, db: torch.Tensor, scores=BWA_SCORES):
    """Score a batch of banded alignments.

    Args:
      query: int32/uint8 [N, L] read codes (0..4), contiguous.
      db:    int32/uint8 [N, L + BAND - 1] window codes, same device.
      scores: (match, mismatch, gap_open, gap_extend), "reward" signed.

    Returns (gfin f32 [N, BAND], tb int32 [N, ceil(L/TB_PACK), BAND]):
    last-row G scores and packed traceback codes (unpack with `unpack_tb`).
    CPU tensors run `banded_sw_torch`; CUDA tensors launch the kernel
    (counted in `banded_sw.launches`) or raise, also for L > MAX_LEN.
    """
    if query.dim() != 2 or db.dim() != 2:
        raise ValueError(f"want 2-D query/db, got {tuple(query.shape)}, "
                         f"{tuple(db.shape)}")
    n, l = query.shape
    if tuple(db.shape) != (n, l + BAND - 1):
        raise ValueError(f"db shape {tuple(db.shape)} != {(n, l + BAND - 1)}")
    for name, t in (("query", query), ("db", db)):
        if t.dtype not in (torch.int32, torch.uint8):
            raise TypeError(f"{name} dtype {t.dtype}: want int32 or uint8")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if query.device != db.device:
        raise ValueError(f"query on {query.device}, db on {db.device}")
    if query.device.type == "cpu":
        return banded_sw_torch(query, db, scores)
    if query.device.type != "cuda":
        raise ValueError(f"banded_sw: unsupported device {query.device}")
    if n == 0 or l == 0:            # nothing to launch; the plain version's shapes
        return (torch.zeros((n, BAND), dtype=torch.float32, device=query.device),
                torch.zeros((n, -(-l // TB_PACK), BAND), dtype=torch.int32,
                            device=query.device))
    return _launch_cuda(query, db, scores)


#: kernel launches on CUDA tensors (the CPU path does not count)
banded_sw.launches = 0


# ---------------------------------------------------------------------------
# traceback walk and rescore (csrc/sw_walk.cu)
# ---------------------------------------------------------------------------

#: int32 words ahead of the runs in an `sw_walk` row: first_db, runs, flags,
#: mismatches, edit distance, normalized score, then the float64
#: log-probability's low and high words
WALK_HDR = 8
#: `sw_walk` flags: the walk holds an I or a D (only then is it rescored);
#: the input was out of range (the row is zero but for this flag)
WALK_GAPPED = 1
WALK_BAD = 2
#: run op codes: run = (length << 2) | op
WALK_OPS = "MID"
#: entries of each float64 quality table the kernel stages
#: (align/quality.py MAX_Q)
WALK_QUALS = 100


def walk_runs(l: int) -> int:
    """Run slots of an `sw_walk` row: a walk of an L-base query takes at
    most 2L + 14 steps (L of M or I; D steps only undo the band offset,
    exit_d <= 15 plus one an I step), so no walk has more runs."""
    return 2 * l + BAND - 1


def _walk_rescore(db, first_db: int, q, ql, cigar, log_match, log_mismatch,
                  norms) -> tuple[float, int, int, int]:
    """(log_prob, mismatches, edit distance, normalized score) of one
    gapped walk, as the kernel sums them: float64 over the M bases in query
    order (a query N always matches, a window N never does), the reference
    read from the window at first_db onwards."""
    norm_mismatch, norm_open, norm_extend, norm_max_extend = norms
    lp, nmm, edit, norm = 0.0, 0, 0, 0
    qpos, rpos = 0, first_db
    for length, op in cigar:
        if op == "M":
            for _ in range(length):
                s, r, qual = int(q[qpos]), int(db[rpos]), int(ql[qpos])
                if s == 4 or (s == r and r != 4):
                    lp += log_match[qual]
                else:
                    lp += log_mismatch[qual]
                    nmm += 1
                    norm += norm_mismatch
                if s != r or s == 4:
                    edit += 1
                qpos += 1
                rpos += 1
        else:
            if op == "I":
                qpos += length
            else:
                rpos += length
            edit += length
            norm += norm_open + min(norm_max_extend,
                                    (length - 1) * norm_extend)
    return lp, nmm, edit, norm


def sw_walk_torch(gfin: torch.Tensor, tb: torch.Tensor, query: torch.Tensor,
                  window: torch.Tensor, quals: torch.Tensor,
                  log_match: torch.Tensor, log_mismatch: torch.Tensor,
                  norms: tuple[int, int, int, int]) -> torch.Tensor:
    """Plain version of the `sw_walk` kernel, per pair on the host:
    `traceback` from numpy's argmax of gfin, `ops_to_cigar` and, for a walk
    with a gap, `_walk_rescore`, laid out as the kernel's rows.  A quality
    past the tables makes the row bad here as there; a walk that leaves the
    band (a traceback `banded_sw` never writes) is bad in the kernel, while
    `traceback` wraps at d = -1."""
    n, l = query.shape
    out = np.zeros((n, WALK_HDR + walk_runs(l)), np.int32)
    g, t, q, db, ql, lm, lmm = (x.cpu().numpy() for x in (
        gfin, tb, query, window, quals, log_match, log_mismatch))
    for k in range(n):
        try:
            ops, first_db = traceback(t[k], int(np.argmax(g[k])), l)
            cigar = ops_to_cigar(ops)
            gapped = any(op != "M" for _, op in cigar)
            lp, nmm, edit, norm = (_walk_rescore(db[k], first_db, q[k], ql[k],
                                                 cigar, lm, lmm, norms)
                                   if gapped else (0.0, 0, 0, 0))
        except IndexError:           # out of the band or of the tables
            out[k, 2] = WALK_BAD
            continue
        out[k, :6] = (first_db, len(cigar), WALK_GAPPED if gapped else 0,
                      nmm, edit, norm)
        out[k, 6:8] = np.array([lp], np.float64).view(np.int32)
        out[k, WALK_HDR:WALK_HDR + len(cigar)] = [
            (length << 2) | WALK_OPS.index(op) for length, op in cigar]
    return torch.from_numpy(out).to(query.device)


@functools.cache
def _walk_launcher():
    """The C launcher of csrc/sw_walk.cu (built on first call), typed."""
    from ._build import load_kernel

    lib = load_kernel("sw_walk")
    for name in ("sw_walk_max_len", "sw_walk_header", "sw_walk_quals"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    got = (lib.sw_walk_max_len(), lib.sw_walk_header(), lib.sw_walk_quals())
    if got != (MAX_LEN, WALK_HDR, WALK_QUALS):
        raise RuntimeError(
            f"csrc/sw_walk.cu has (L limit, header, table entries) {got}; "
            f"sw.py has {(MAX_LEN, WALK_HDR, WALK_QUALS)}")
    fn = lib.sw_walk_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def sw_walk(gfin: torch.Tensor, tb: torch.Tensor, query: torch.Tensor,
            window: torch.Tensor, quals: torch.Tensor, log_match: torch.Tensor,
            log_mismatch: torch.Tensor,
            norms: tuple[int, int, int, int]) -> torch.Tensor:
    """Walk each pair's traceback and rescore its gapped alignment.

    Args:
      gfin, tb: `banded_sw`'s outputs for these pairs.
      query:  uint8 [N, L] oriented read codes, as given to `banded_sw`.
      window: uint8 [N, L + BAND - 1] window codes, as given to `banded_sw`.
      quals:  uint8 [N, L] oriented base qualities.
      log_match, log_mismatch: float64 [WALK_QUALS] log-probability of a
        matching and of a mismatching base, by quality.
      norms: the normalized (mismatch, gap open, gap extend, max gap
        extend) scores.

    Returns int32 [N, WALK_HDR + walk_runs(L)]: per pair the header, then
    its CIGAR runs in query order (`decode_walk`, `walk_cigar`).  CPU
    tensors run `sw_walk_torch`; CUDA tensors launch the kernel (counted in
    `sw_walk.launches`) or raise, also for L > MAX_LEN.
    """
    n, l = query.shape
    shapes = {"gfin": (gfin, (n, BAND), torch.float32),
              "tb": (tb, (n, -(-l // TB_PACK), BAND), torch.int32),
              "query": (query, (n, l), torch.uint8),
              "window": (window, (n, l + BAND - 1), torch.uint8),
              "quals": (quals, (n, l), torch.uint8),
              "log_match": (log_match, (WALK_QUALS,), torch.float64),
              "log_mismatch": (log_mismatch, (WALK_QUALS,), torch.float64)}
    for name, (t, shape, dtype) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}, want "
                             f"{dtype} {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != query.device:
            raise ValueError(f"{name} on {t.device}, query on {query.device}")
    norms = tuple(int(x) for x in norms)
    if len(norms) != 4:
        raise ValueError(f"norms: want 4 scores, got {norms}")
    dev = query.device
    if dev.type == "cpu":
        return sw_walk_torch(gfin, tb, query, window, quals, log_match,
                             log_mismatch, norms)
    if dev.type != "cuda":
        raise ValueError(f"sw_walk: unsupported device {dev}")
    if n == 0 or l == 0:            # nothing to launch
        return torch.zeros((n, WALK_HDR + walk_runs(l)), dtype=torch.int32,
                           device=dev)
    if l > MAX_LEN:
        raise ValueError(f"sw_walk kernel takes L <= {MAX_LEN}, got {l}")
    fn = _walk_launcher()
    out = torch.empty((n, WALK_HDR + walk_runs(l)), dtype=torch.int32,
                      device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(gfin.data_ptr(), tb.data_ptr(), query.data_ptr(),
                window.data_ptr(), quals.data_ptr(), log_match.data_ptr(),
                log_mismatch.data_ptr(), n, l, *norms, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"sw_walk kernel launch failed: CUDA error {rc}")
    sw_walk.launches += 1
    return out


#: kernel launches on CUDA tensors (the CPU path does not count)
sw_walk.launches = 0


def decode_walk(rows: np.ndarray) -> dict[str, np.ndarray]:
    """`sw_walk` rows (on the host) -> their header fields by name."""
    return {"first_db": rows[:, 0], "runs": rows[:, 1], "flags": rows[:, 2],
            "mismatches": rows[:, 3], "edit": rows[:, 4], "norm": rows[:, 5],
            "log_prob": np.ascontiguousarray(rows[:, 6:8]).view(
                np.float64)[:, 0]}


def walk_cigar(row: np.ndarray) -> str:
    """One `sw_walk` row's runs as a CIGAR string."""
    runs = row[WALK_HDR:WALK_HDR + row[1]]
    return "".join(f"{r >> 2}{WALK_OPS[r & 3]}" for r in runs.tolist())


# ---------------------------------------------------------------------------
# host helpers (numpy; same as the JAX package's)
# ---------------------------------------------------------------------------

def unpack_tb(tb_packed: np.ndarray, l: int) -> np.ndarray:
    """Packed [.., ceil(L/TB_PACK), BAND] traceback words -> per-row 6-bit
    codes [.., L, BAND]."""
    tb_packed = np.asarray(tb_packed)
    rows = np.arange(l)
    words = tb_packed[..., rows // TB_PACK, :]
    shifts = (6 * (rows % TB_PACK))[..., :, None]
    return (words >> shifts) & 63


def pack_tb(tb_rows: np.ndarray) -> np.ndarray:
    """Per-row codes [L, BAND] -> packed words [ceil(L/TB_PACK), BAND]."""
    l, band = tb_rows.shape
    groups = -(-l // TB_PACK)
    out = np.zeros((groups, band), np.int32)
    for i in range(l):
        out[i // TB_PACK] |= tb_rows[i] << (6 * (i % TB_PACK))
    return out


def banded_sw_numpy_batch(queries: np.ndarray, dbs: np.ndarray,
                          scores=BWA_SCORES):
    """Vectorized numpy oracle over a batch of pairs: queries [N, L] int,
    dbs [N, L+BAND-1] int -> (g [N, BAND], tb [N, ceil(L/TB_PACK), BAND]).
    float32 throughout, so sentinel-region tie-breaks agree exactly."""
    match_s, mismatch_s, open_s, extend_s = (np.float32(s) for s in scores)
    neg = np.float32(NEG)
    n, l = queries.shape
    g = np.zeros((n, BAND), np.float32)
    e = np.full((n, BAND), neg, np.float32)
    f = np.full((n, BAND), neg, np.float32)
    tb = np.zeros((n, l, BAND), np.int32)
    up_fill = np.full((n, 1), neg, np.float32)

    def up(x):
        return np.concatenate([x[:, 1:], up_fill], axis=1)

    for i in range(l):
        q_i = queries[:, i : i + 1]
        w = np.where((q_i == dbs[:, i : i + BAND]) & (q_i < 4),
                     match_s, mismatch_s)
        m_prev = np.maximum(np.maximum(g, e), f)
        tg = np.where(e > np.maximum(g, f), 1, np.where(f > g, 2, 0))
        new_g = m_prev + w
        fg, fe, ff = up(g) + open_s, up(e) + open_s, up(f) + extend_s
        new_f = np.maximum(np.maximum(fg, fe), ff)
        tf = np.where(fe > np.maximum(fg, ff), 1, np.where(ff > fg, 2, 0))
        new_e = np.full((n, BAND), neg, np.float32)
        te = np.zeros((n, BAND), np.int32)
        for d in range(1, BAND):
            fg2 = new_g[:, d - 1] + open_s
            ff2 = new_f[:, d - 1] + open_s
            fe2 = new_e[:, d - 1] + extend_s
            new_e[:, d] = np.maximum(np.maximum(fg2, ff2), fe2)
            te[:, d] = np.where(fe2 > np.maximum(fg2, ff2), 1,
                                np.where(ff2 > fg2, 2, 0))
        tb[:, i] = tg + te * 4 + tf * 16
        g, e, f = new_g, new_e, new_f

    groups = -(-l // TB_PACK)
    pad = groups * TB_PACK - l
    if pad:
        tb = np.concatenate(
            [tb, np.zeros((n, pad, BAND), np.int32)], axis=1)
    tb = tb.reshape(n, groups, TB_PACK, BAND)
    shifts = (6 * np.arange(TB_PACK, dtype=np.int32))[None, None, :, None]
    packed = np.bitwise_or.reduce(tb << shifts, axis=2)
    return g, packed


def traceback(tb_packed: np.ndarray, exit_d: int, l: int | None = None):
    """Walk one packed traceback matrix from (L-1, exit_d) in state G.

    Returns (ops, first_db): CIGAR ops 'M','I','D' in query order and the
    window-relative index of the first database base consumed.
    """
    if l is None:
        l = tb_packed.shape[0] * TB_PACK
    tb = unpack_tb(tb_packed, l)
    i, d, state = l - 1, int(exit_d), 0
    ops: list[str] = []
    first_db = 0
    while i >= 0:
        code = tb[i, d]
        if state == 0:       # G: consumed q_i vs db_{i+d}
            ops.append("M")
            first_db = i + d
            state = code & 3
            i -= 1
        elif state == 1:     # E: deletion, consumed db_{i+d} only
            ops.append("D")
            first_db = i + d
            state = (code >> 2) & 3
            d -= 1
        else:                # F: insertion, consumed query only
            ops.append("I")
            state = (code >> 4) & 3
            i -= 1
            d += 1
    ops.reverse()
    return ops, first_db


def ops_to_cigar(ops: list[str]) -> list[tuple[int, str]]:
    out: list[tuple[int, str]] = []
    for op in ops:
        if out and out[-1][1] == op:
            out[-1] = (out[-1][0] + 1, op)
        else:
            out.append((1, op))
    return out
