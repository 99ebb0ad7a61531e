"""Neighbor annotation: mark k-mers having <=N-mismatch neighbors elsewhere
in the genome.

The port's own copy of `isaac_aligner_tpu/index/neighbors.py` (host numpy),
unchanged but for the `device` that `annotate_index` and
`annotate_index_chunked` hand to the device program
(`index/neighbors_device.py`).  Reference analog: oligo::Permutate
(src/c++/include/oligo/Permutate.hh:42-106, lib/oligo/Permutate.cpp:125-175)
and NeighborsFinder (src/c++/lib/reference/NeighborsFinder.cpp:66-384).

The algorithm is the reference's pigeonhole block design: split the k-mer
into 2*E equal blocks; any two k-mers within Hamming distance <= E (in
bases) differ in at most E blocks, so for SOME choice of E clean blocks
moved to the prefix the two k-mers share an equal prefix.  For every
C(2E, E) block selection: permute, sort, scan equal-prefix runs, and mark
pairs whose suffix differs in 1..E bases.  Marked k-mers get the "has
neighbors" bit that demotes their seeds' anchoring confidence (MAPQ
gating, TemplateBuilder::updateMappingScore).

`find_neighbors` is the host oracle: equal-prefix runs are found with one
diff over the sorted array, and runs longer than `run_cap` are truncated
(the reference's repeat-threshold gating).
"""

from __future__ import annotations

import itertools

import numpy as np

#: annotation width (mismatches), reference neighborhoodWidth=4
#: (include/reference/NeighborsFinder.hh:75)
DEFAULT_WIDTH = 4


def block_permutations(error_count: int = DEFAULT_WIDTH) -> list[tuple[int, ...]]:
    """All prefix selections of `error_count` blocks out of 2*error_count.

    Each permutation lists the block order (prefix blocks first), blocks
    numbered from the most significant end — the reference's ABCD-chain
    (Permutate.cpp:125-175) enumerates the same C(2E, E) selections.
    """
    n = 2 * error_count
    perms = []
    for prefix in itertools.combinations(range(n), error_count):
        suffix = tuple(i for i in range(n) if i not in prefix)
        perms.append(prefix + suffix)
    return perms


def permute_blocks(kmers: np.ndarray, order: tuple[int, ...], k: int) -> np.ndarray:
    """Rearrange the 2-bit blocks of packed k-mers into `order`.

    kmers: uint64 array of big-endian packed k-mers; block 0 is the most
    significant.  Vectorized shift/mask per block (2E shifts total).
    """
    n_blocks = len(order)
    block_bases = k // n_blocks
    bb = 2 * block_bases
    mask = np.uint64((1 << bb) - 1)
    out = np.zeros_like(kmers)
    for dst, src in enumerate(order):
        src_shift = np.uint64((n_blocks - 1 - src) * bb)
        dst_shift = np.uint64((n_blocks - 1 - dst) * bb)
        out |= ((kmers >> src_shift) & mask) << dst_shift
    return out


def _base_mismatches_u64(x: np.ndarray) -> np.ndarray:
    """Count differing 2-bit bases given XOR of two packed k-mers."""
    lo = (x | (x >> np.uint64(1))) & np.uint64(0x5555555555555555)
    # popcount of lo
    v = lo
    v = v - ((v >> np.uint64(1)) & np.uint64(0x5555555555555555))
    v = (v & np.uint64(0x3333333333333333)) + ((v >> np.uint64(2)) & np.uint64(0x3333333333333333))
    v = (v + (v >> np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    return (v * np.uint64(0x0101010101010101)) >> np.uint64(56)


def _scan_sorted_runs(s: np.ndarray, prefix_shift: np.uint64,
                      suffix_mask: np.uint64, error_count: int,
                      run_cap: int, pair_budget: int = 1 << 22) -> np.ndarray:
    """Mark entries of a SORTED permuted-k-mer array having >=1 neighbor
    (suffix Hamming <= error_count) within their equal-prefix run.

    Vectorized over runs: runs are grouped by (capped) length so the
    pairwise XOR/popcount runs as batched [R, L, L] tensor ops instead of
    a Python loop per run (the reference's markNeighbors scan,
    NeighborsFinder.cpp:258-341, batched).  `pair_budget` bounds the
    elements of one batch tensor (bounded RAM).
    """
    n = s.shape[0]
    out = np.zeros(n, dtype=bool)
    if n < 2:
        return out
    pref = s >> prefix_shift
    starts = np.flatnonzero(np.concatenate([[True], pref[1:] != pref[:-1]]))
    lens = np.diff(np.concatenate([starts, [n]]))
    multi = lens >= 2
    starts = starts[multi]
    lens = np.minimum(lens[multi], run_cap)
    if starts.size == 0:
        return out
    for length in np.unique(lens):
        sl = starts[lens == length]
        length = int(length)
        max_b = max(1, pair_budget // (length * length))
        span = np.arange(length)
        for j in range(0, sl.size, max_b):
            st = sl[j : j + max_b]
            idx = st[:, None] + span[None, :]
            suf = s[idx] & suffix_mask
            diff = suf[:, :, None] ^ suf[:, None, :]
            mm = _base_mismatches_u64(diff)
            near = mm <= error_count
            near &= ~np.eye(length, dtype=bool)[None, :, :]
            hit = near.any(axis=2)
            out[idx[hit]] = True
    return out


def _perm_geometry(k: int, error_count: int):
    n_blocks = 2 * error_count
    bb = 2 * (k // n_blocks)
    prefix_shift = np.uint64(error_count * bb)
    suffix_mask = np.uint64((1 << (error_count * bb)) - 1)
    return prefix_shift, suffix_mask


def find_neighbors(kmers: np.ndarray, k: int = 32,
                   error_count: int = DEFAULT_WIDTH,
                   run_cap: int = 256) -> np.ndarray:
    """Return a bool array marking k-mers with >=1 neighbor within
    `error_count` mismatches among the OTHER k-mers in the input.

    `kmers` should be the UNIQUE k-mers (uint64, any order).  Runs of
    equal prefixes longer than `run_cap` are truncated (quadratic scan
    bound, analogous to the reference's repeat gating).
    """
    kmers = np.asarray(kmers, dtype=np.uint64)
    n = kmers.shape[0]
    has = np.zeros(n, dtype=bool)
    if n < 2:
        return has
    prefix_shift, suffix_mask = _perm_geometry(k, error_count)
    for order in block_permutations(error_count):
        permuted = permute_blocks(kmers, order, k)
        idx = np.argsort(permuted, kind="stable")
        hit = _scan_sorted_runs(permuted[idx], prefix_shift, suffix_mask,
                                error_count, run_cap)
        has[idx[hit]] = True
    return has


def annotate_index(key_hi: np.ndarray, key_lo: np.ndarray, k: int,
                   error_count: int = DEFAULT_WIDTH,
                   run_cap: int = 256,
                   key_mids: tuple = (),
                   device="cuda") -> np.ndarray:
    """Neighbor bits for SORTED (possibly duplicated) index key planes.

    Unbiases the int32 planes to uint32 words, deduplicates, annotates
    unique k-mers (the device program on `device`, or the host scan, as
    `neighbors_device.annotate_unique_auto` routes), and expands back to
    per-record bits.  64-mer indexes pass their two middle planes via
    `key_mids`."""
    from .build import unbias_i32_to_u32
    from .neighbors_device import annotate_unique_auto

    if k == 64:
        planes = (key_hi, key_mids[0], key_mids[1], key_lo)
    elif k == 32:
        planes = (key_hi, key_lo)
    else:
        planes = (key_hi,)
    words = [unbias_i32_to_u32(np.asarray(p)) for p in planes]
    n = words[0].shape[0]
    if n == 0:
        return np.zeros(0, bool)
    # consecutive-dedup over the SORTED planes (lexicographic)
    new = np.zeros(n, bool)
    new[0] = True
    for w in words:
        new[1:] |= w[1:] != w[:-1]
    inverse = np.cumsum(new) - 1
    uniq = tuple(w[new] for w in words)
    bits = annotate_unique_auto(uniq, k, error_count=error_count,
                                run_cap=run_cap, device=device)
    return bits[inverse]


# ---------------------------------------------------------------------------
# Bounded-RAM annotation (human-scale index planes, possibly memory-mapped)
# ---------------------------------------------------------------------------

def _unique_kmers_streaming(key_hi, key_lo, k: int, chunk: int,
                            store) -> int:
    """Stream the SORTED key planes, write unique packed k-mers to `store`
    (a writable uint64 array-like), return the unique count."""
    from .build import unbias_i32_to_u32

    n = key_hi.shape[0]
    n_uniq = 0
    prev = None
    for lo_i in range(0, n, chunk):
        hi_i = min(lo_i + chunk, n)
        hi = unbias_i32_to_u32(np.asarray(key_hi[lo_i:hi_i])).astype(np.uint64)
        lo = unbias_i32_to_u32(np.asarray(key_lo[lo_i:hi_i])).astype(np.uint64)
        km = (hi << np.uint64(32)) | lo if k == 32 else hi
        new = np.empty(km.shape[0], dtype=bool)
        new[0] = prev is None or km[0] != prev
        new[1:] = km[1:] != km[:-1]
        u = km[new]
        store[n_uniq : n_uniq + u.shape[0]] = u
        n_uniq += u.shape[0]
        prev = km[-1]
    return n_uniq


def _expand_bits_streaming(key_hi, key_lo, k: int, chunk: int,
                           uniq_bits: np.ndarray, out) -> None:
    """Expand per-unique-k-mer bits back to per-record bits, streamed."""
    from .build import unbias_i32_to_u32

    n = key_hi.shape[0]
    upos = -1       # running unique index (index of current record's k-mer)
    prev = None
    for lo_i in range(0, n, chunk):
        hi_i = min(lo_i + chunk, n)
        hi = unbias_i32_to_u32(np.asarray(key_hi[lo_i:hi_i])).astype(np.uint64)
        lo = unbias_i32_to_u32(np.asarray(key_lo[lo_i:hi_i])).astype(np.uint64)
        km = (hi << np.uint64(32)) | lo if k == 32 else hi
        new = np.empty(km.shape[0], dtype=bool)
        new[0] = prev is None or km[0] != prev
        new[1:] = km[1:] != km[:-1]
        uidx = upos + np.cumsum(new)
        out[lo_i:hi_i] = uniq_bits[uidx].astype(np.uint8)
        upos = int(uidx[-1])
        prev = km[-1]


def annotate_index_chunked(key_hi, key_lo, k: int,
                           error_count: int = DEFAULT_WIDTH,
                           run_cap: int = 256,
                           out_path=None,
                           chunk: int = 1 << 24,
                           mem_records: int = 1 << 27,
                           part_bits: int = 8,
                           work_dir=None,
                           device="cuda") -> np.ndarray:
    """Bounded-RAM neighbor annotation over (possibly memory-mapped)
    sorted key planes.

    Reference analog: findNeighbors as a separate out-of-core make target
    (src/make/reference/SortReference.mk:92-97,
    lib/reference/NeighborsFinder.cpp:193-384).  Recomposed:

    1. Streaming dedup of the sorted planes into a unique-k-mer array
       (memory-mapped scratch when the index exceeds `mem_records`).
    2. Per block permutation: permute in chunks, radix-partition the
       permuted k-mers by their top `part_bits` bits into scratch files
       (a permuted prefix run never spans partitions — the partition key
       is a prefix of the run key), then per partition sort + batched
       pairwise suffix-Hamming scan (`_scan_sorted_runs`).
    3. Streaming expansion of unique bits back to per-record bits.

    Peak RAM: O(chunk) + one partition (~n_unique / 2^part_bits records).
    Small indexes (< `mem_records` unique) skip the disk partitioning and
    annotate their unique k-mers in one call, on `device` as
    `neighbors_device.annotate_unique_auto` routes.
    """
    import tempfile
    from pathlib import Path

    n = key_hi.shape[0]
    if n == 0:
        return np.zeros(0, np.uint8)

    with tempfile.TemporaryDirectory(
            dir=str(work_dir) if work_dir else None) as tmp_name:
        tmp = Path(tmp_name)
        # -- 1. streaming dedup ---------------------------------------------
        big = n > mem_records
        if big:
            uniq_store = np.lib.format.open_memmap(
                tmp / "uniq.npy", mode="w+", dtype=np.uint64, shape=(n,))
        else:
            uniq_store = np.empty(n, np.uint64)
        n_uniq = _unique_kmers_streaming(key_hi, key_lo, k, chunk, uniq_store)
        uniq = uniq_store[:n_uniq]

        prefix_shift, suffix_mask = _perm_geometry(k, error_count)
        bits = np.zeros(n_uniq, dtype=bool)

        if not big:
            from .neighbors_device import annotate_unique_auto
            u = np.asarray(uniq)
            if k == 32:
                up = ((u >> np.uint64(32)).astype(np.uint32),
                      (u & np.uint64(0xFFFFFFFF)).astype(np.uint32))
            else:
                up = (u.astype(np.uint32),)
            bits[:] = annotate_unique_auto(up, k, error_count=error_count,
                                           run_cap=run_cap, device=device)
        else:
            n_parts = 1 << part_bits
            pshift = np.uint64(64 - part_bits) if k == 32 else \
                np.uint64(32 - part_bits)
            for order in block_permutations(error_count):
                part_paths = [tmp / f"part_{p:03d}.bin" for p in range(n_parts)]
                # partition pass (chunked, append-per-chunk)
                for lo_i in range(0, n_uniq, chunk):
                    hi_i = min(lo_i + chunk, n_uniq)
                    permuted = permute_blocks(np.asarray(uniq[lo_i:hi_i]),
                                              order, k)
                    part = (permuted >> pshift).astype(np.int64)
                    po = np.argsort(part, kind="stable")
                    recs = np.empty((permuted.shape[0], 2), np.uint64)
                    recs[:, 0] = permuted[po]
                    recs[:, 1] = (np.arange(lo_i, hi_i, dtype=np.uint64))[po]
                    bounds = np.searchsorted(part[po], np.arange(n_parts + 1))
                    for p in range(n_parts):
                        b, e = bounds[p], bounds[p + 1]
                        if e > b:
                            with open(part_paths[p], "ab") as f:
                                f.write(recs[b:e].tobytes())
                # per-partition sort + scan
                for p in range(n_parts):
                    pp = part_paths[p]
                    if not pp.exists():
                        continue
                    arr = np.fromfile(pp, dtype=np.uint64).reshape(-1, 2)
                    pp.unlink()
                    so = np.argsort(arr[:, 0], kind="stable")
                    s = arr[so, 0]
                    hit = _scan_sorted_runs(s, prefix_shift, suffix_mask,
                                            error_count, run_cap)
                    bits[arr[so, 1][hit].astype(np.int64)] = True

        # -- 3. streaming expansion ------------------------------------------
        if out_path is not None and big:
            out = np.lib.format.open_memmap(out_path, mode="w+",
                                            dtype=np.uint8, shape=(n,))
        else:
            out = np.empty(n, np.uint8)
        _expand_bits_streaming(key_hi, key_lo, k, chunk, bits, out)
    return out
