"""2-bit sequence ops on tensors: seed packing, reverse complement, the
2-bit-base Hamming distance of packed words.

Port of `isaac_aligner_tpu/ops/bitops.py`.  torch has no full uint32, so
uint32 values ride in int64 carriers, masked to 32 bits after every left
shift (the JAX shifts wrap modulo 2^32 by design).  Keys are bias-encoded
into int32 exactly as the index stores them (`index/build.py`).
"""

from __future__ import annotations

import torch

from .. import dna

#: low 32 bits of an int64 carrier
U32_MASK = 0xFFFFFFFF


def bias_keys(u32: torch.Tensor) -> torch.Tensor:
    """uint32 values (int64 carrier) -> order-preserving int32.

    `x ^ 0x80000000` reinterpreted as int32 equals `x - 2**31` for every
    x in [0, 2**32), so no bitcast is needed."""
    return (u32 - (1 << 31)).to(torch.int32)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of uint32 values in int64 carriers."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def base_mismatches32(x: torch.Tensor) -> torch.Tensor:
    """Count of differing 2-bit bases given the XOR of two packed uint32
    words (int64 carriers, masked to 32 bits by the caller)."""
    return popcount32((x | (x >> 1)) & 0x55555555)


def revcomp_reads(bases: torch.Tensor) -> torch.Tensor:
    """[B, L] uint8 codes -> reverse-complement codes (N stays N)."""
    comp = torch.where(bases < dna.NUM_BASES, 3 - bases, bases)
    return comp.flip(1)


def reverse_quals(quals: torch.Tensor) -> torch.Tensor:
    return quals.flip(1)


def pack_seed(bases: torch.Tensor, offset: int, seed_len: int):
    """Pack one seed per read from [B, L] codes at a static offset.

    Returns (key_hi, key_lo) as biased int32 [B] and `has_n` bool [B].
    For seed_len 16 the low word is 0 (matching the index build); a
    64-mer is two 32-mer packs (hi, mid1) and (mid2, lo).
    """
    if seed_len not in (16, 32):
        raise ValueError("seed_len must be 16 or 32")
    window = bases[:, offset : offset + seed_len].to(torch.int64)
    has_n = (window >= dna.NUM_BASES).any(dim=1)
    w = torch.where(window >= dna.NUM_BASES, 0, window)

    def fold(cols):
        v = torch.zeros(bases.shape[0], dtype=torch.int64, device=bases.device)
        for j in cols:
            v = ((v << 2) & U32_MASK) | w[:, j]
        return v

    hi = fold(range(16))
    lo = fold(range(16, 32)) if seed_len == 32 else torch.zeros_like(hi)
    return bias_keys(hi), bias_keys(lo), has_n
