"""Branchless binary search over sorted multi-word key planes (torch).

Port of `isaac_aligner_tpu/ops/search.py`.  Every query seed
binary-searches the device-resident sorted index with a fixed number of
gather steps, data-parallel across the batch.  Keys are biased int32
planes compared lexicographically, outermost first: (hi, lo) for 16/32-mers,
(hi, mid1, mid2, lo) for the 64-mer index.  Probe positions are int64 and
every gather index is clamped in range (JAX clamps silently, torch raises
on the CPU and faults on CUDA).  `sorted_prefix_range` gives the block of
records sharing a query's high word (the neighbor pass).
"""

from __future__ import annotations

import torch

I32_MAX = 2**31 - 1


def _lex_lt_n(words, q_words):
    """Lexicographic <, outermost word first; words/q_words same length."""
    r = words[-1] < q_words[-1]
    for w, q in zip(reversed(words[:-1]), reversed(q_words[:-1])):
        r = (w < q) | ((w == q) & r)
    return r


def _lex_le_n(words, q_words):
    r = words[-1] <= q_words[-1]
    for w, q in zip(reversed(words[:-1]), reversed(q_words[:-1])):
        r = (w < q) | ((w == q) & r)
    return r


def pad_pow2(n: int) -> int:
    """Smallest power of two >= max(n, 1)."""
    p = 1
    while p < n:
        p *= 2
    return p


def _count_prefix(planes, pred, out_shape):
    """Number of leading records satisfying `pred` (pred true on a prefix).

    Step sizes n, n/2, ..., 1 reach any answer in [0, n]; probes are
    clamped in range and guarded so out-of-range steps never fire.
    """
    n_pad = planes[0].shape[0]
    if n_pad & (n_pad - 1):
        raise ValueError("key planes must be padded to a power of two")
    pos = torch.zeros(out_shape, dtype=torch.int64, device=planes[0].device)
    step = n_pad
    while step >= 1:
        probe = torch.clamp(pos + (step - 1), max=n_pad - 1)
        ok = (pos + step <= n_pad) & pred(tuple(p[probe] for p in planes))
        pos = torch.where(ok, pos + step, pos)
        step //= 2
    return pos


def _key_tuples(key_hi, key_lo, q_hi, q_lo, key_mids, q_mids):
    """(planes, query words) in outer->inner comparison order."""
    return (key_hi, *key_mids, key_lo), (q_hi, *q_mids, q_lo)


def sorted_range(key_hi, key_lo, q_hi, q_lo, n_real: int,
                 key_mids=(), q_mids=()):
    """Match range of each query key in the sorted key planes.

    Planes are padded to a power-of-two length with I32_MAX sentinels;
    the range is clamped to `n_real` so the padding is never reported as
    a match (the all-T k-mer's biased key equals the sentinel).
    `key_mids`/`q_mids` carry the two middle words of 64-mer keys (empty
    for 16/32-mers).

    Returns (begin, count) int32 tensors with the query shape.
    """
    planes, qs = _key_tuples(key_hi, key_lo, q_hi, q_lo, key_mids, q_mids)
    lower = _count_prefix(planes, lambda ws: _lex_lt_n(ws, qs), q_hi.shape)
    upper = _count_prefix(planes, lambda ws: _lex_le_n(ws, qs), q_hi.shape)
    lower = torch.clamp(lower, max=n_real)
    upper = torch.clamp(upper, max=n_real)
    return lower.to(torch.int32), (upper - lower).to(torch.int32)


def _count_prefix_bounded(planes, pred, lo, hi, start_step: int):
    """Like _count_prefix but searching only [lo, hi) per query, with a
    static power-of-two step schedule starting at start_step.  Requires
    start_step >= (hi - lo) for every query."""
    n_pad = planes[0].shape[0]
    pos = lo
    step = start_step
    while step >= 1:
        probe = torch.clamp(pos + (step - 1), max=n_pad - 1)
        ok = (pos + step <= hi) & pred(tuple(p[probe] for p in planes))
        pos = torch.where(ok, pos + step, pos)
        step //= 2
    return pos


def sorted_range_bucketed(key_hi, key_lo, q_hi, q_lo, n_real: int,
                          bucket_starts, width: int, bucket_log2: int,
                          count_cap_log2: int | None = None,
                          key_mids=(), q_mids=()):
    """sorted_range accelerated by a first-level prefix-bucket table.

    `bucket_starts` [2^width + 1] maps each key's top `width` bits to its
    record range, so the search runs over one bucket: `bucket_log2`+1
    probe steps instead of log2(N)+1.  With `count_cap_log2` the upper
    bound is only resolved within [lower, lower + 2^count_cap_log2], so
    the count saturates there (callers only need "count <= threshold").
    The bucket comes from `q_hi`'s top bits for every key width.
    """
    planes, qs = _key_tuples(key_hi, key_lo, q_hi, q_lo, key_mids, q_mids)
    # unbias to uint32 in an int64 carrier: the shift below is then
    # logical (torch's >> on int32 would be arithmetic)
    qu = q_hi.to(torch.int64) + (1 << 31)
    bucket = qu >> (32 - width)
    lo = bucket_starts[bucket].to(torch.int64)
    hi = bucket_starts[bucket + 1].to(torch.int64)
    start_step = 1 << bucket_log2
    lower = _count_prefix_bounded(
        planes, lambda ws: _lex_lt_n(ws, qs), lo, hi, start_step)
    if count_cap_log2 is not None and count_cap_log2 < bucket_log2:
        hi = torch.minimum(hi, lower + (1 << count_cap_log2))
        upper = _count_prefix_bounded(
            planes, lambda ws: _lex_le_n(ws, qs), lower, hi,
            1 << count_cap_log2)
    else:
        upper = _count_prefix_bounded(
            planes, lambda ws: _lex_le_n(ws, qs), lo, hi, start_step)
    lower = torch.clamp(lower, max=n_real)
    upper = torch.clamp(upper, max=n_real)
    return lower.to(torch.int32), (upper - lower).to(torch.int32)


def sorted_prefix_range(key_hi, q_hi, n_real: int):
    """Match range of each query's high word alone (the 16-base prefix
    block of the reference's NeighborMaskMatcher): (begin, count) int32 of
    all records whose key_hi equals q_hi, whatever their lower words.  The
    search runs over the whole padded plane, not a bucket."""
    planes = (key_hi,)
    lower = _count_prefix(planes, lambda ws: ws[0] < q_hi, q_hi.shape)
    upper = _count_prefix(planes, lambda ws: ws[0] <= q_hi, q_hi.shape)
    lower = torch.clamp(lower, max=n_real)
    upper = torch.clamp(upper, max=n_real)
    return lower.to(torch.int32), (upper - lower).to(torch.int32)
