"""2-bit DNA base codec and small host-side sequence utilities.

The port's own copy of `isaac_aligner_tpu/dna.py`, unchanged.  Base codes follow the reference convention (reference:
src/c++/include/oligo/Nucleotides.hh — A=0, C=1, G=2, T=3) with code 4
for any ambiguous base (N and every other IUPAC letter).  All hot-path
arrays carry these small integer codes; ASCII only exists at the I/O
boundary.
"""

from __future__ import annotations

import numpy as np

A, C, G, T, N = 0, 1, 2, 3, 4

#: number of distinct unambiguous bases
NUM_BASES = 4

# ASCII -> code lookup (everything unknown maps to N)
BASE_TO_CODE = np.full(256, N, dtype=np.uint8)
for _i, _ch in enumerate("ACGT"):
    BASE_TO_CODE[ord(_ch)] = _i
    BASE_TO_CODE[ord(_ch.lower())] = _i

CODE_TO_BASE = np.frombuffer(b"ACGTN", dtype=np.uint8)


def encode(seq: str | bytes | bytearray) -> np.ndarray:
    """ASCII sequence -> uint8 code array (A=0..T=3, N=4)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    raw = np.frombuffer(bytes(seq), dtype=np.uint8)
    return BASE_TO_CODE[raw]


def decode(codes: np.ndarray) -> str:
    """uint8 code array -> ASCII string."""
    return CODE_TO_BASE[np.asarray(codes, dtype=np.uint8)].tobytes().decode("ascii")


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of a code array; N stays N."""
    codes = np.asarray(codes)
    comp = np.where(codes < NUM_BASES, 3 - codes, codes).astype(codes.dtype)
    return comp[::-1].copy()


def complement(codes: np.ndarray) -> np.ndarray:
    codes = np.asarray(codes)
    return np.where(codes < NUM_BASES, 3 - codes, codes).astype(codes.dtype)


def pack_kmer(codes: np.ndarray) -> int:
    """Pack up to 32 unambiguous bases into a big-endian 2-bit integer.

    First base occupies the most significant bits (so lexicographic base
    order == integer order), matching the sorted-index comparison order.
    """
    v = 0
    for b in np.asarray(codes):
        if b >= NUM_BASES:
            raise ValueError("cannot pack ambiguous base into k-mer")
        v = (v << 2) | int(b)
    return v


def unpack_kmer(value: int, k: int) -> np.ndarray:
    out = np.empty(k, dtype=np.uint8)
    for i in range(k - 1, -1, -1):
        out[i] = value & 3
        value >>= 2
    return out
