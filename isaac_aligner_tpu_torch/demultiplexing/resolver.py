"""Barcode resolution: observed index reads -> sample-sheet barcodes.

Reference analog: demultiplexing::BarcodeResolver
(src/c++/include/demultiplexing/BarcodeResolver.hh:33-50, called from
FindMatchesTransition.cpp:112-166): each cluster's barcode bases are
matched against every expected barcode with a PER-COMPONENT mismatch
budget (reference --barcode-mismatches, default 1 per component); N
counts as a mismatch; ties or budget misses fall into the "unknown" bin
(index -1).

The port's own copy of `isaac_aligner_tpu/demultiplexing/resolver.py`,
unchanged.  Vectorized: [B, n_barcodes] Hamming distances in one numpy op
— the whole resolution is a couple of compares over the batch, on the
host (in the output process when it runs).
"""

from __future__ import annotations

import numpy as np

from .. import dna
from .samplesheet import BarcodeSpec

UNKNOWN = -1


def resolve_barcodes(observed: np.ndarray, specs: list[BarcodeSpec],
                     mismatches_per_component: int = 1) -> np.ndarray:
    """Resolve observed barcode base codes against the expected list.

    observed: uint8 [B, Lb] code array of the concatenated barcode read
    (dual-index components concatenated WITHOUT separator).
    Returns int32 [B] of BarcodeSpec.index, or UNKNOWN.
    """
    b = observed.shape[0]
    indexed = [s for s in specs if not s.is_no_index]
    if not indexed:
        # single unindexed sample: everything resolves to it
        return np.full(b, specs[0].index, np.int32)

    comp_lens = [len(c) for c in indexed[0].components]
    for s in indexed:
        if [len(c) for c in s.components] != comp_lens:
            raise ValueError("all sample-sheet barcodes must share geometry")
    total = sum(comp_lens)
    if observed.shape[1] < total:
        raise ValueError(
            f"barcode read too short: {observed.shape[1]} < {total}")
    obs = observed[:, :total]

    ok = np.ones((b, len(indexed)), bool)
    off = 0
    for ci, cl in enumerate(comp_lens):
        seg = obs[:, off : off + cl]
        exp = np.stack([dna.encode(s.components[ci]) for s in indexed])  # [N, cl]
        # an N base already differs from every expected code, so the plain
        # inequality count covers the reference's N-penalty rule
        mm = (seg[:, None, :] != exp[None, :, :]).sum(axis=2)
        ok &= mm <= mismatches_per_component
        off += cl
    n_ok = ok.sum(axis=1)
    first = np.argmax(ok, axis=1)
    out = np.full(b, UNKNOWN, np.int32)
    unique_hit = n_ok == 1
    out[unique_hit] = np.array([indexed[i].index for i in first[unique_hit]],
                               np.int32)
    # multiple matches within budget are ambiguous -> unknown (reference
    # resolves ties by failing the cluster into the unknown barcode)
    return out
