"""Neighbor annotation on the device: the permute -> sort -> scan pigeonhole
pass in torch.

Port of `isaac_aligner_tpu/index/neighbors_tpu.py` (`find_neighbors_device`
:110-223 and `annotate_unique_auto` :336-381).  The same C(2E, E) block
design as `index/neighbors.py`:

- the UNIQUE k-mers upload once as uint32 words in int64 carriers (so every
  shift is logical and no value wraps);
- per block permutation: the permuted blocks repack into words, one sort
  orders them (the keys are unique, so any correct sort gives the same
  order: a single int64 key for 16/32-mers, two stable passes for the
  128-bit 64-mer), and a WINDOWED scan compares row i with rows i+1..i+W:
  equal prefix words and 1..E differing suffix bases mark both rows; the
  marks go back to k-mer order through the sort index;
- 2-bit-base Hamming via XOR + (x|x>>1)&0x5555... + popcount.

For any equal-prefix run of length <= W the window examines exactly the
pairs the host scan does; for longer runs it examines a superset of the
host path's run-capped pairs.  The scan stops at the longest equal-prefix
run of each permutation (no pair lies further apart), which changes no
mark.

Supports 16/32/64-mer keys: 2k bits over 8 blocks gives block widths of
4/8/16 bits, so a permuted k-mer repacks into the same word layout and the
prefix (the first E blocks) is exactly the leading half of the bit string.

The JAX package's partitioned program (`DEVICE_SORT_MAX`) worked around a
TPU fault on large sorts and is not ported: one sort covers every size up
to `DEVICE_MAX_RECORDS`.  A failure of the device program raises; nothing
falls back to the host scan.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import require_device
from ..ops.bitops import U32_MASK, base_mismatches32
from .neighbors import DEFAULT_WIDTH, block_permutations

#: device-path size bound (records); larger inputs take the host scan
#: (`annotate_unique_auto`, the JAX package's routing)
DEVICE_MAX_RECORDS = 200_000_000


def _geometry(k: int) -> tuple[int, int, int]:
    """(n_words, block_bits, blocks_per_word) for 8-block keys."""
    n_words = max(1, (2 * k) // 32)
    block_bits = (2 * k) // 8
    return n_words, block_bits, 8 // n_words


def _key64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Two uint32 words -> one int64 ordered like the unsigned 64-bit
    word: (hi - 2^31) * 2^32 + lo."""
    return (hi - (1 << 31)) * (1 << 32) + lo


def _sort_index(pw: list[torch.Tensor]) -> torch.Tensor:
    """Permutation that sorts the word planes lexicographically."""
    if len(pw) == 1:
        return torch.sort(pw[0]).indices
    if len(pw) == 2:
        return torch.sort(_key64(pw[0], pw[1])).indices
    idx = torch.sort(_key64(pw[2], pw[3]), stable=True).indices
    hi = _key64(pw[0], pw[1])[idx]
    return idx[torch.sort(hi, stable=True).indices]


def find_neighbors_device(planes, k: int,
                          error_count: int = DEFAULT_WIDTH,
                          window: int = 256, device="cuda",
                          stats: dict | None = None) -> np.ndarray:
    """Bool bits for UNIQUE k-mers given their UNBIASED uint32 word
    planes (tuple of [n] arrays, most-significant first), computed on
    `device`.

    Per permutation: repack -> sort -> windowed suffix-Hamming scan over
    d = 1..min(window, longest equal-prefix run - 1), OR-ing the marks.
    `stats`, when given, receives the longest equal-prefix run over all
    permutations and the number of scan steps run."""
    if error_count != DEFAULT_WIDTH:
        raise ValueError("block design fixed at 8 blocks (error_count 4)")
    n_words, block_bits, bpw = _geometry(k)
    if len(planes) != n_words:
        raise ValueError(f"{len(planes)} word planes for k={k}, want {n_words}")
    n = int(planes[0].shape[0])
    dev = require_device(device)
    if n < 2:
        return np.zeros(n, bool)
    # uint32 words travel as int32 and widen on the device
    words = [torch.from_numpy(np.asarray(p, np.uint32).view(np.int32)).to(dev)
             .to(torch.int64) & U32_MASK for p in planes]
    mask = (1 << block_bits) - 1
    bits = torch.zeros(n, dtype=torch.bool, device=dev)
    max_run, steps = 1, 0
    for order in block_permutations(error_count):
        def block(j):
            sh = 32 - block_bits * (j % bpw + 1)
            return (words[j // bpw] >> sh) & mask

        pw = []
        for w in range(n_words):
            acc = torch.zeros(n, dtype=torch.int64, device=dev)
            for s in range(bpw):
                acc |= block(order[w * bpw + s]) << (32 - block_bits * (s + 1))
            pw.append(acc)
        idx = _sort_index(pw)
        sw = [w[idx] for w in pw]
        # prefix = the first 4 blocks = the leading half of the bit string
        if n_words == 1:
            pref, suf = [sw[0] >> 16], [sw[0] & 0xFFFF]
        elif n_words == 2:
            pref, suf = [sw[0]], [sw[1]]
        else:
            pref, suf = sw[:2], sw[2:]

        # rows continuing the previous row's equal-prefix run; the longest
        # run bounds the distance of any pair
        cont = torch.ones(n, dtype=torch.bool, device=dev)
        for w in pref:
            cont[1:] &= w[1:] == w[:-1]
        run = int(torch.bincount(torch.cumsum(~cont, 0)).max())
        max_run = max(max_run, run)
        hit = torch.zeros(n, dtype=torch.bool, device=dev)
        for d in range(1, min(window, run - 1) + 1):
            same = pref[0][:-d] == pref[0][d:]
            for w in pref[1:]:
                same &= w[:-d] == w[d:]
            mm = base_mismatches32(suf[0][:-d] ^ suf[0][d:])
            for w in suf[1:]:
                mm += base_mismatches32(w[:-d] ^ w[d:])
            near = same & (mm <= error_count) & (mm > 0)
            hit[:-d] |= near
            hit[d:] |= near
            steps += 1
        marks = torch.empty_like(hit)
        marks[idx] = hit          # idx is a permutation: no duplicates
        bits |= marks
    if stats is not None:
        stats.update(max_run=max_run, scan_steps=steps)
    return bits.cpu().numpy()


def annotate_unique_auto(uniq_planes, k: int,
                         error_count: int = DEFAULT_WIDTH,
                         run_cap: int = 256,
                         device="cuda") -> np.ndarray:
    """Device-or-host neighbor bits for unique k-mers.

    `uniq_planes`: tuple of unbiased uint32 word arrays (MSB first).  The
    device program runs on `device` when E=4, the input fits
    DEVICE_MAX_RECORDS and run_cap <= 4096 (the windowed scan costs
    O(window) steps; an uncapped run_cap belongs on the host run scan);
    the host scan covers the rest.  The two see different pairs in prefix
    runs longer than the window, so these bounds are the JAX package's."""
    n = uniq_planes[0].shape[0]
    if (error_count == DEFAULT_WIDTH and n <= DEVICE_MAX_RECORDS
            and run_cap <= 4096):
        return find_neighbors_device(uniq_planes, k, error_count=error_count,
                                     window=run_cap, device=device)
    from .neighbors import find_neighbors
    if k <= 32:
        hi = uniq_planes[0].astype(np.uint64)
        if k == 32:
            km = (hi << np.uint64(32)) | uniq_planes[1].astype(np.uint64)
        else:
            km = hi
        return find_neighbors(km, k=k, error_count=error_count,
                              run_cap=run_cap)
    raise NotImplementedError(
        "64-mer host neighbor scan: use the device path")
