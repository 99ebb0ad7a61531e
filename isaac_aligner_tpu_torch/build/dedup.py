"""Coordinate sorting and duplicate marking.

Reference analog: BinSorter::process (src/c++/lib/build/BinSorter.cpp:36-421)
and DuplicatePairEndFilter / DuplicateFragmentIndexFiltering
(include/build/DuplicateFragmentIndexFiltering.hh:43-180).

Semantics reproduced:
- duplicate key: per-end anchor = (reference id, UNCLIPPED 5' alignment
  position, orientation); paired records group by the canonically ordered
  (self anchor, mate anchor) pair, single-end by their own anchor (the
  reference's Se/FStrand/RStrandOrShadow index flavors collapse to this
  for mapped reads; shadow-hash anchoring for unmapped mates is
  approximated by the mate's anchor).
- ranking (io/Fragment.hh:66-71): rank = quality_sum << 32 |
  (total_len - edit_distance) << 16 | alignment_score; the highest rank
  in a group is kept, the rest get FLAG_DUPLICATE (or are dropped when
  keep=False, reference --keep-duplicates/--mark-duplicates).

The port's own copy of the columnar path of `isaac_aligner_tpu/build/
dedup.py` (`coordinate_sort_order`, `mark_duplicates_batch`), unchanged,
and `mark_duplicates_collective`, the Build phase's marker under
`--devices N` (parallel/sharded.collective_dedup).
"""

from __future__ import annotations

from ..io import sam


def coordinate_sort_order(fb) -> "np.ndarray":
    """Row order for BAM coordinate sorting (vectorized
    PackedFragmentBuffer::orderForBam): (contig, pos, qname), records
    without a position last."""
    import numpy as np
    tid = fb.template_ids()           # lexicographic name rank
    n_refs = int(fb.ref_id.max()) + 1 if len(fb) else 0
    ref_key = np.where(fb.ref_id >= 0, fb.ref_id, n_refs)
    pos_key = np.where(fb.ref_id >= 0, fb.pos, 0)
    return np.lexsort((tid, pos_key, ref_key))


def _dup_classes(fb):
    """Per-record duplicate class column (shared by the host and the
    collective markers): 0=pe, 1=half (mapped end, shadow mate),
    2=shadow, 3=se, -1=skip."""
    import numpy as np

    n = len(fb)
    paired = (fb.flag & sam.FLAG_PAIRED).astype(bool)
    self_mapped = ~(fb.flag & sam.FLAG_UNMAPPED).astype(bool)
    mate_mapped = ~(fb.flag & sam.FLAG_MATE_UNMAPPED).astype(bool)
    cls = np.full(n, -1, np.int64)
    cls[paired & self_mapped & mate_mapped] = 0
    cls[paired & self_mapped & ~mate_mapped] = 1
    cls[paired & ~self_mapped & mate_mapped] = 2
    cls[~paired & self_mapped] = 3
    return cls


def mark_duplicates_batch(fb, contig_offsets, keep: bool = True,
                          lib=None):
    """Vectorized per-bin duplicate marking on a FragmentBatch.

    Reference semantics (DuplicateFragmentIndexFiltering.hh:43-180):
    each RECORD groups by (class, library, own anchor, mate anchor) using
    the dedup columns precomputed at conversion time
    (storage.finalize_dup_columns); the highest template-level
    duplicateClusterRank wins its group, every other record gets
    FLAG_DUPLICATE.  Because both ends of a template carry the same rank
    and mirrored anchors, per-bin decisions agree across bins even when
    a pair's two records land in different bins.  Returns the batch
    (rows dropped when keep=False).
    """
    import numpy as np

    n = len(fb)
    if n == 0:
        return fb
    cls = _dup_classes(fb)
    lib = fb.rg.astype(np.int64) if lib is None else np.asarray(lib, np.int64)
    dup = np.zeros(n, bool)
    ci = np.nonzero(cls >= 0)[0]
    if ci.size:
        g_order = ci[np.lexsort((-fb.dup_tie[ci], -fb.dup_rank[ci],
                                 fb.anchor_mate[ci], fb.anchor_self[ci],
                                 lib[ci], cls[ci]))]
        same = np.zeros(len(g_order), bool)
        if len(g_order) > 1:
            p, q = g_order[1:], g_order[:-1]
            same[1:] = ((cls[p] == cls[q]) & (lib[p] == lib[q])
                        & (fb.anchor_self[p] == fb.anchor_self[q])
                        & (fb.anchor_mate[p] == fb.anchor_mate[q]))
        dup[g_order[same]] = True

    fb.flag = np.where(dup, fb.flag | sam.FLAG_DUPLICATE,
                       fb.flag).astype(np.uint16)
    if keep:
        return fb
    return fb.take(np.nonzero(~dup)[0])


def mark_duplicates_collective(fb, mesh, keep: bool = True, lib=None):
    """Duplicate marking over every device of `mesh` (in row order): the
    grouping and rank/tie pick of mark_duplicates_batch, run by
    parallel.sharded.collective_dedup (records route to their anchor's
    owner device, owners sort and mark, flags route home).  Rows are
    padded to a multiple of the device count with skipped records; rows
    over a device's receive capacity stay unmarked, and a log line says
    how many."""
    import numpy as np

    from ..parallel.sharded import collective_dedup

    n = len(fb)
    if n == 0:
        return fb
    cls = _dup_classes(fb)
    lib = fb.rg.astype(np.int64) if lib is None else np.asarray(lib, np.int64)
    n_dev = len(mesh.flat)
    pad = (-n) % n_dev

    def padded(v, fill=0):
        v = np.asarray(v, np.int64)
        return np.concatenate([v, np.full(pad, fill, np.int64)]) if pad else v

    flags, overflow = collective_dedup(
        mesh, padded(fb.anchor_self), padded(fb.anchor_mate),
        padded(fb.dup_rank), padded(fb.dup_tie), padded(cls, -1),
        padded(lib))
    dup = flags[:n]
    n_over = int(overflow.sum())
    if n_over:
        from ..utils import tracing
        tracing.log(f"collective dedup: {n_over} rows overflowed receive "
                    f"capacity and were kept unmarked", force=True)
    fb.flag = np.where(dup, fb.flag | sam.FLAG_DUPLICATE,
                       fb.flag).astype(np.uint16)
    if keep:
        return fb
    return fb.take(np.nonzero(~dup)[0])
