"""Vectorized fragment storage: device results -> columnar records -> bins.

Reference analog: the MatchSelector output path —
lib/alignment/matchSelector/BinningFragmentStorage.cpp (pack each
BamTemplate into fragment records and route them to genomic bins chosen
by BinIndexMap, include/alignment/matchSelector/BinIndexMap.hh:44-96) and
FragmentCollector.hh.  Here each aligned batch converts to a
`FragmentBatch` with pure numpy column math (no per-read Python) and
appends to per-bin chunk files, so the whole-run record set never lives
in RAM at once.

The port's own copy of the single-end and paired-end parts of
`isaac_aligner_tpu/build/storage.py`, unchanged.  Not ported yet:
`from_sam_records` (BAM input, ROADMAP queue A item 9); the workflow
refuses that input.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from ..io import sam
from . import records as R
from .records import FragmentBatch

_ABSENT = R._ABSENT


def _name_matrix(names, idx: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    from ..io.fastq import LazyNames
    if isinstance(names, LazyNames):
        return names.matrix(idx)
    arr = np.array(list(names), dtype="S")[idx]
    w = max(1, arr.dtype.itemsize)
    mat = arr.view(np.uint8).reshape(len(arr), w)
    lens = np.char.str_len(arr).astype(np.int32)
    return mat, lens


def _orient_output(bases: np.ndarray, quals: np.ndarray, lengths: np.ndarray,
                   rev: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-row reverse-complement of the first `length` columns where rev."""
    n, L = bases.shape
    ar = np.arange(L)[None, :]
    ridx = np.where(rev[:, None], np.maximum(lengths[:, None] - 1 - ar, 0), ar)
    seq = np.take_along_axis(bases, ridx, axis=1)
    q = np.take_along_axis(quals, ridx, axis=1)
    comp = np.where(seq < 4, 3 - seq, seq).astype(np.uint8)
    seq = np.where(rev[:, None], comp, seq)
    return seq.astype(np.uint8), q.astype(np.uint8)


def _oriented_from_result(res: dict, sfx: str, batch, idx: np.ndarray,
                          lengths: np.ndarray, rev: np.ndarray):
    """Output-oriented seq/qual columns.  Since round 4 the device does
    NOT ship seq/qual back (fetch payload was the e2e wall): the host
    path below orients from the reads it already holds.  The seq_out
    branch remains for result dicts that carry device-oriented columns
    (tests / external callers of the unpacked SPMD entry points)."""
    key = "seq_out" + sfx
    if key not in res:
        return _orient_output(batch.bases[idx], batch.quals[idx],
                              lengths, rev)
    w = batch.bases.shape[1]
    seq = np.asarray(res[key])[idx][:, :w]
    qual = np.asarray(res["qual_out" + sfx])[idx][:, :w]
    rev_dev = np.asarray(res["orient_rev" + sfx])[idx].astype(bool)
    fix = np.nonzero(rev != rev_dev)[0]
    if fix.size:
        s2, q2 = _orient_output(batch.bases[idx][fix], batch.quals[idx][fix],
                                lengths[fix], rev[fix])
        seq[fix] = s2
        qual[fix] = q2
    return seq, qual


def _subset_cigars(cigars, idx: np.ndarray):
    if cigars is None:
        return None
    return np.array(list(cigars) + [None], dtype=object)[:-1][idx]


def _locate(contig_offsets: np.ndarray, gpos: np.ndarray
            ) -> tuple[np.ndarray, np.ndarray]:
    """Global positions -> (contig id, contig-local position), vectorized."""
    rid = (np.searchsorted(contig_offsets, gpos, side="right") - 1).astype(np.int32)
    rid = np.maximum(rid, 0)
    return rid, (gpos - contig_offsets[rid]).astype(np.int32)


@dataclasses.dataclass
class AuxColumns:
    """Optional per-read columns threaded into the records (RG/BC/ZX/ZY)."""
    rg: np.ndarray | None = None        # int32 per read, -1 absent
    rg_names: tuple[str, ...] = ()
    bc: np.ndarray | None = None        # uint8 [N, W] barcode ascii
    zx: np.ndarray | None = None        # int32 cluster X
    zy: np.ndarray | None = None        # int32 cluster Y

    def take(self, idx: np.ndarray) -> "AuxColumns":
        pick = lambda v: v[idx] if v is not None else None
        return AuxColumns(rg=pick(self.rg), rg_names=self.rg_names,
                          bc=pick(self.bc), zx=pick(self.zx), zy=pick(self.zy))


def _apply_aux(fb: FragmentBatch, aux: AuxColumns | None) -> None:
    if aux is None:
        return
    n = len(fb)
    rep = 2 if (fb.flag & sam.FLAG_PAIRED).any() else 1

    def spread(v):
        return np.repeat(v, rep, axis=0) if rep == 2 else v
    if aux.rg is not None:
        fb.rg = spread(aux.rg).astype(np.int32)
        fb.rg_names = tuple(aux.rg_names)
    if aux.bc is not None:
        fb.bc = spread(aux.bc)
    if aux.zx is not None:
        fb.zx = spread(aux.zx).astype(np.int32)
    if aux.zy is not None:
        fb.zy = spread(aux.zy).astype(np.int32)
    assert len(fb.flag) == n


def from_single_result(genome, batch, res: dict, mapq_cap: int = 60,
                       aux: AuxColumns | None = None,
                       mapq_threshold: int = 0) -> FragmentBatch:
    """Vectorized single-end result -> FragmentBatch
    (aligner.Aligner._records_from_res semantics).  `mapq_threshold`
    drops fragments below the MAPQ bar (reference --mapq-threshold,
    manual.md:421-424): they become unaligned records."""
    names = batch.names
    # padding rows are always trailing (pad_batch) — n_valid avoids a
    # per-name startswith scan
    idx = np.arange(batch.n_valid)
    n = idx.size
    lengths = batch.lengths[idx].astype(np.int32)
    aligned = np.asarray(res["aligned"])[idx].astype(bool)
    if mapq_threshold > 0:
        aligned = aligned & (np.asarray(res["mapq"])[idx].astype(np.int64)
                             >= mapq_threshold)
    rev = aligned & np.asarray(res["reverse"])[idx].astype(bool)
    start = np.asarray(res["start"])[idx].astype(np.int64)

    ops, n_ops = R.cigars_to_ops(_subset_cigars(res.get("cigar"), idx), lengths)
    n_ops = np.where(aligned, n_ops, 0).astype(np.int16)

    offs = genome.contig_offsets
    rid, local = _locate(offs, np.maximum(start, 0))
    seq, qual = _oriented_from_result(res, "", batch, idx, lengths, rev)

    fb = FragmentBatch.empty(n, batch.bases.shape[1],
                             name_w=1, max_cigar=ops.shape[1])
    fb.name_bytes, fb.name_len = _name_matrix(names, idx)
    fb.flag = (np.where(aligned, 0, sam.FLAG_UNMAPPED)
               | np.where(rev, sam.FLAG_REVERSE, 0)).astype(np.uint16)
    fb.ref_id = np.where(aligned, rid, -1).astype(np.int32)
    fb.pos = np.where(aligned, local, -1).astype(np.int32)
    mapq = np.asarray(res["mapq"])[idx].astype(np.int64)
    fb.mapq = np.where(aligned, np.minimum(mapq, 255), 0).astype(np.uint8)
    fb.cigar_ops = ops
    fb.n_cigar = n_ops
    fb.seq, fb.qual, fb.length = seq, qual, lengths
    nm = np.asarray(res["edit_distance"])[idx].astype(np.int32)
    fb.nm = np.where(aligned, nm, _ABSENT).astype(np.int32)
    fb.sm = np.where(aligned, np.minimum(mapq, 255), _ABSENT).astype(np.int32)
    _apply_aux(fb, aux.take(idx) if aux is not None else None)
    finalize_dup_columns(fb, genome.contig_offsets)
    return fb


def from_paired_result(genome, b1, b2, res: dict, mapq_cap: int = 60,
                       aux: AuxColumns | None = None,
                       pessimistic: bool = False,
                       mapq_threshold: int = 0) -> FragmentBatch:
    """Vectorized paired result -> FragmentBatch, rows interleaved
    (R1_0, R2_0, R1_1, R2_1, ...).  Field mapping matches
    aligner._pair_records (FragmentAccessorBamAdapter analog) exactly.
    """
    from ..align import tls as tls_mod
    names = b1.names
    # padding rows are always trailing (pad_batch)
    idx = np.arange(b1.n_valid)
    n = idx.size
    offs = genome.contig_offsets

    end = {}
    for e, batch in ((1, b1), (2, b2)):
        lengths = batch.lengths[idx].astype(np.int32)
        aligned = np.asarray(res[f"aligned_{e}"])[idx].astype(bool)
        rev = aligned & np.asarray(res[f"reverse_{e}"])[idx].astype(bool)
        start = np.asarray(res[f"start_{e}"])[idx].astype(np.int64)
        frag = np.where(aligned,
                        np.asarray(res[f"frag_score_{e}"])[idx], 0).astype(np.int64)
        nm = np.where(aligned,
                      np.asarray(res[f"edit_distance_{e}"])[idx], 0).astype(np.int32)
        ops, n_ops = R.cigars_to_ops(
            _subset_cigars(res.get(f"cigar_{e}"), idx), lengths)
        obs = R.ref_span(ops, n_ops.astype(np.int64)).astype(np.int64)
        obs = np.where(aligned, obs, lengths)
        rid, local = _locate(offs, np.maximum(start, 0))
        seq, qual = _oriented_from_result(res, f"_{e}", batch, idx,
                                          lengths, rev)
        end[e] = dict(lengths=lengths, aligned=aligned, rev=rev, start=start,
                      frag=frag, nm=nm, ops=ops,
                      n_ops=np.where(aligned, n_ops, 0).astype(np.int16),
                      obs=obs, rid=rid, local=local, seq=seq, qual=qual)

    a1, a2 = end[1]["aligned"], end[2]["aligned"]
    proper = np.asarray(res["proper_pair"])[idx].astype(bool) & a1 & a2
    tscore = np.asarray(res["template_score"])[idx].astype(np.int64)
    both = a1 & a2
    same_ref = both & (end[1]["rid"] == end[2]["rid"])
    tlen_mag = np.where(
        same_ref,
        tls_mod.template_length(end[1]["start"], end[1]["obs"],
                                end[2]["start"], end[2]["obs"]), 0)

    def end_mapq(e):
        me = end[e]
        base = np.minimum(me["frag"], mapq_cap)
        # --bam-pessimistic-mapq: min(SM, AS) instead of max
        combine = np.minimum if pessimistic else np.maximum
        boosted = np.minimum(combine(me["frag"], tscore), mapq_cap)
        return np.where(me["aligned"],
                        np.where(proper & (tscore >= 0), boosted, base), 0)

    mapq = {1: end_mapq(1), 2: end_mapq(2)}

    if mapq_threshold > 0:
        # reference --mapq-threshold: only TEMPLATES whose mapping
        # quality clears the bar are reported (manual.md:421-424); both
        # ends of a failing template become unaligned records
        keep = np.maximum(mapq[1], mapq[2]) >= mapq_threshold
        for e, batch in ((1, b1), (2, b2)):
            # dropped reverse-aligned rows: re-emit FORWARD seq/qual so
            # the cleared FLAG_REVERSE stays consistent with the bytes
            fix = np.nonzero(end[e]["rev"] & ~keep)[0]
            if fix.size:
                w = end[e]["seq"].shape[1]
                end[e]["seq"][fix] = batch.bases[idx][fix][:, :w]
                end[e]["qual"][fix] = batch.quals[idx][fix][:, :w]
            end[e]["aligned"] = end[e]["aligned"] & keep
            end[e]["rev"] = end[e]["rev"] & keep
            end[e]["n_ops"] = np.where(keep, end[e]["n_ops"], 0) \
                .astype(np.int16)
        a1, a2 = end[1]["aligned"], end[2]["aligned"]
        proper = proper & keep
        both = a1 & a2
        same_ref = both & (end[1]["rid"] == end[2]["rid"])
        tlen_mag = np.where(
            same_ref,
            tls_mod.template_length(end[1]["start"], end[1]["obs"],
                                    end[2]["start"], end[2]["obs"]), 0)
        tscore = np.where(keep, tscore, -1)
        mapq = {e: np.where(keep, mapq[e], 0) for e in (1, 2)}

    parts = []
    for e in (1, 2):
        me, mate = end[e], end[3 - e]
        m_al, o_al = me["aligned"], mate["aligned"]
        flag = np.full(n, sam.FLAG_PAIRED
                       | (sam.FLAG_READ1 if e == 1 else sam.FLAG_READ2),
                       np.uint16)
        flag |= np.where(proper, sam.FLAG_PROPER_PAIR, 0).astype(np.uint16)
        flag |= np.where(~m_al, sam.FLAG_UNMAPPED, 0).astype(np.uint16)
        flag |= np.where(~o_al, sam.FLAG_MATE_UNMAPPED, 0).astype(np.uint16)
        flag |= np.where(me["rev"], sam.FLAG_REVERSE, 0).astype(np.uint16)
        flag |= np.where(mate["rev"], sam.FLAG_MATE_REVERSE, 0).astype(np.uint16)

        # placement: unmapped rows sit at the mate's coordinates
        ref_id = np.where(m_al, me["rid"], np.where(o_al, mate["rid"], -1))
        pos = np.where(m_al, me["local"], np.where(o_al, mate["local"], -1))
        mate_ref = np.where(o_al, mate["rid"], np.where(m_al, me["rid"], -1))
        mate_pos = np.where(o_al, mate["local"], np.where(m_al, pos, -1))

        lower = (me["start"] < mate["start"]) | \
            ((me["start"] == mate["start"]) & (e == 1))
        tlen = np.where(both & (tlen_mag != 0),
                        np.where(lower, tlen_mag, -tlen_mag), 0)

        fb = FragmentBatch.empty(n, me["seq"].shape[1], name_w=1,
                                 max_cigar=max(end[1]["ops"].shape[1],
                                               end[2]["ops"].shape[1]))
        fb.name_bytes, fb.name_len = _name_matrix(names, idx)
        fb.flag = flag
        fb.ref_id = ref_id.astype(np.int32)
        fb.pos = pos.astype(np.int32)
        fb.mapq = np.minimum(mapq[e], 255).astype(np.uint8)
        fb.cigar_ops[:, : me["ops"].shape[1]] = me["ops"]
        fb.n_cigar = me["n_ops"]
        fb.seq, fb.qual = me["seq"], me["qual"]
        fb.length = me["lengths"]
        fb.mate_ref_id = mate_ref.astype(np.int32)
        fb.mate_pos = mate_pos.astype(np.int32)
        fb.tlen = tlen.astype(np.int32)
        fb.nm = np.where(m_al, me["nm"], _ABSENT).astype(np.int32)
        fb.sm = np.where(m_al, me["frag"], _ABSENT).astype(np.int32)
        fb.as_ = np.where(m_al & proper & (tscore >= 0), tscore,
                          _ABSENT).astype(np.int32)
        fb.mq = np.where(o_al, mapq[3 - e], _ABSENT).astype(np.int32)
        fb.mc_ops[:, : mate["ops"].shape[1]] = mate["ops"]
        fb.n_mc = np.where(o_al, mate["n_ops"], 0).astype(np.int16)
        parts.append(fb)

    # interleave rows: template i -> rows 2i (R1), 2i+1 (R2)
    order = np.empty(2 * n, np.int64)
    order[0::2] = np.arange(n)
    order[1::2] = n + np.arange(n)
    fb1, fb2 = parts
    cat = R.concat([fb1, fb2])
    out = cat.take(order)
    _apply_aux(out, aux.take(idx) if aux is not None else None)
    finalize_dup_columns(out, genome.contig_offsets)
    return out


# ---------------------------------------------------------------------------
# Genomic binning store (BinIndexMap / BinningFragmentStorage analog)
# ---------------------------------------------------------------------------

_HASH_MASK = (1 << 61) - 1
_HASH_FLAG = 1 << 62   # marks bases-hash pseudo anchors (unmapped ends)


def _bases_hash(seq: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Vectorized polynomial hash of each row's first `length` codes
    (reference FragmentIndexAnchor hashes shadow bases,
    include/build/FragmentIndex.hh:36-90)."""
    n, L = seq.shape
    in_read = np.arange(L)[None, :] < lengths[:, None]
    pows = np.empty(L, np.uint64)
    p = np.uint64(1099511628211)
    pows[0] = 1
    with np.errstate(over="ignore"):       # uint64 wraparound is the point
        for j in range(1, L):
            pows[j] = pows[j - 1] * p
    vals = (seq.astype(np.uint64) + 1) * in_read
    h = (vals * pows[None, :]).sum(axis=1, dtype=np.uint64)
    return (h & np.uint64(_HASH_MASK)).astype(np.int64)


def _name_hash(name_bytes: np.ndarray, name_len: np.ndarray) -> np.ndarray:
    """Deterministic per-template tiebreak from the read name."""
    n, W = name_bytes.shape
    used = np.arange(W)[None, :] < name_len[:, None]
    pows = np.empty(W, np.uint64)
    p = np.uint64(131)
    pows[0] = 1
    with np.errstate(over="ignore"):
        for j in range(1, W):
            pows[j] = pows[j - 1] * p
    vals = (name_bytes.astype(np.uint64) + 1) * used
    h = (vals * pows[None, :]).sum(axis=1, dtype=np.uint64)
    return (h & np.uint64(_HASH_MASK)).astype(np.int64)


def finalize_dup_columns(fb: FragmentBatch, contig_offsets: np.ndarray
                         ) -> None:
    """Precompute duplicate-index columns on a conversion-time batch
    (rows still interleaved R1,R2 per template for paired data).

    Reference analog: MatchSelector writes FragmentIndex records (own +
    mate anchors) and a template-level duplicateClusterRank next to each
    fragment (FragmentIndex.hh:36-186, io/Fragment.hh:398) so the Build
    phase dedups each bin without ever consulting the mate's bin."""
    n = len(fb)
    if n == 0:
        fb.anchor_self = np.zeros(0, np.int64)
        fb.anchor_mate = np.zeros(0, np.int64)
        fb.dup_rank = np.zeros(0, np.int64)
        fb.dup_tie = np.zeros(0, np.int64)
        return
    paired = bool((fb.flag & sam.FLAG_PAIRED).any())
    mapped = (~(fb.flag & sam.FLAG_UNMAPPED).astype(bool)) & (fb.ref_id >= 0)
    anchor = unclipped_5prime_global(fb, contig_offsets)
    rev = (fb.flag & sam.FLAG_REVERSE).astype(bool)
    fb.anchor_self = anchor * 2 + rev
    um = np.nonzero(~mapped)[0]
    if um.size:   # bases-hash pseudo anchors only for the unmapped subset
        fb.anchor_self[um] = \
            _bases_hash(fb.seq[um], fb.length[um]) | _HASH_FLAG
    if paired:
        fb.anchor_mate = fb.anchor_self.reshape(-1, 2)[:, ::-1].reshape(-1)
    else:
        fb.anchor_mate = np.full(n, -1, np.int64)

    # template-level rank (qual sum, length - edit, score), legacy _rank
    L = fb.qual.shape[1]
    in_read = np.arange(L)[None, :] < fb.length[:, None]
    qsum = (fb.qual.astype(np.int64) * in_read).sum(axis=1)
    edit = np.maximum(fb.nm, 0).astype(np.int64)
    score = fb.mapq.astype(np.int64)
    tlen_ = fb.length.astype(np.int64)
    if paired:
        def tsum(v):
            return np.repeat(v.reshape(-1, 2).sum(axis=1), 2)
        qsum, edit, score, tlen_ = map(tsum, (qsum, edit, score, tlen_))
    fb.dup_rank = ((qsum << 32) | (np.maximum(tlen_ - edit, 0) << 16)
                   | np.minimum(score, 0xFFFF))
    fb.dup_tie = _name_hash(fb.name_bytes, fb.name_len)


def unclipped_5prime_global(fb: FragmentBatch, contig_offsets: np.ndarray
                            ) -> np.ndarray:
    """Global unclipped-5' anchor position per row (dedup/binning key;
    reference FragmentIndexAnchor).  -1 for unmapped rows."""
    mapped = (~(fb.flag & sam.FLAG_UNMAPPED).astype(bool)) & (fb.ref_id >= 0)
    gpos = np.where(mapped,
                    contig_offsets[np.maximum(fb.ref_id, 0)] + fb.pos, -1)
    lead, tail = R.clip_spans(fb.cigar_ops, fb.n_cigar)
    span = R.ref_span(fb.cigar_ops, fb.n_cigar.astype(np.int64)).astype(np.int64)
    rev = (fb.flag & sam.FLAG_REVERSE).astype(bool)
    fwd_anchor = gpos - lead
    rev_anchor = gpos + span - 1 + tail
    return np.where(mapped, np.where(rev, rev_anchor, fwd_anchor), -1)


def record_bin_ids(fb: FragmentBatch, contig_offsets: np.ndarray,
                   bin_bp: int, n_bins: int,
                   boundaries: np.ndarray | None = None) -> np.ndarray:
    """Per-record genomic bin from the record's BAM placement position
    (reference BinIndexMap: each fragment routes independently; shadows
    ride their placement next to the mate).  Records without any position
    get bin n_bins (the trailing unaligned bin).  Binning by placement —
    not by unclipped anchor — keeps the concatenated per-bin outputs in
    exact global coordinate order; the dedup columns each record carries
    (anchor_self/mate + dup_rank) make per-bin duplicate marking exact
    without the mate's bin.

    `boundaries` (sorted bin-start global positions, boundaries[0] == 0)
    switches from equal genome spans to match-distribution-driven cuts
    (reference MatchDistribution.hh:43-107 + BinIndexMap.hh:44-96):
    coverage-skewed runs get equal RECORD mass per bin, keeping the
    --memory-limit contract."""
    placed = fb.ref_id >= 0
    gpos = np.where(placed,
                    contig_offsets[np.maximum(fb.ref_id, 0)] + fb.pos, -1)
    if boundaries is not None:
        bin_id = np.searchsorted(boundaries, np.maximum(gpos, 0),
                                 side="right") - 1
    else:
        bin_id = np.minimum(np.maximum(gpos, 0) // bin_bp, n_bins - 1)
    return np.where(placed, bin_id, n_bins).astype(np.int64)


class BinnedFragmentStore:
    """Append-only per-bin chunk files of FragmentBatch columns.

    The out-of-core half of BinningFragmentStorage: each add() routes a
    batch's rows to genomic bins and appends one .npz chunk per touched
    bin, so peak RAM is one batch regardless of run size.
    """

    def __init__(self, bins_dir: str | Path, contig_offsets: np.ndarray,
                 genome_bp: int, n_bins: int,
                 boundaries: np.ndarray | None = None,
                 ram_cache_records: int = 0, pre_sort: bool = False):
        self.dir = Path(bins_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.offsets = contig_offsets
        if boundaries is not None:
            boundaries = np.asarray(boundaries, np.int64)
            assert boundaries[0] == 0 and np.all(np.diff(boundaries) >= 0)
            n_bins = len(boundaries)
        self.boundaries = boundaries
        self.n_bins = max(1, n_bins)
        self.bin_bp = max(1, -(-genome_bp // self.n_bins))
        self._chunk = 0
        self.records = 0
        # write-through RAM cache of the chunk batches (disk stays
        # authoritative — crash/resume re-reads the files): runs that fit
        # one bin budget skip the Build phase's chunk re-read entirely,
        # which was a measurable slice of 2-core-host CPU.  The cache
        # DROPS itself once the run outgrows the budget.
        self._cache_cap = ram_cache_records
        self._cache: dict[str, list] | None = \
            {} if ram_cache_records > 0 else None
        # reference --pre-sort-bins (manual.md:457): position-sort each
        # chunk at write time so Build-phase bin sorts see nearly-sorted
        # input (final output is identical either way)
        self._pre_sort = pre_sort

    def add(self, fb: FragmentBatch, seq: int | None = None) -> None:
        """Route one batch to bins.  `seq` pins the chunk file number
        (multi-host: the GLOBAL batch index, so chunks from different
        hosts interleave into single-process record order)."""
        if len(fb) == 0:
            return
        chunk_no = self._chunk if seq is None else int(seq)
        bins = record_bin_ids(fb, self.offsets, self.bin_bp, self.n_bins,
                              self.boundaries)
        self.records += len(fb)
        for b in np.unique(bins):
            rows = np.nonzero(bins == b)[0]
            sub = fb.take(rows)
            name = "unaligned" if b == self.n_bins else f"bin_{int(b):05d}"
            if self._pre_sort and b != self.n_bins:
                order = np.lexsort((sub.pos, sub.ref_id))
                if not np.array_equal(order, np.arange(len(sub))):
                    sub = sub.take(order)
            d = self.dir / name
            d.mkdir(exist_ok=True)
            sub.save(d / f"chunk_{chunk_no:06d}.cols")
            if self._cache is not None:
                self._cache.setdefault(name, []).append(sub)
        if self._cache is not None and self.records > self._cache_cap:
            self._cache = None
        self._chunk = max(self._chunk + 1, chunk_no + 1)

    def cached_bin(self, name: str) -> "FragmentBatch | None":
        """The RAM copy of one bin (or None when uncached/dropped)."""
        if self._cache is None or name not in self._cache:
            return None
        return R.concat(self._cache[name])

    def cached_chunks(self, name: str):
        """The RAM chunk list of one bin (unaligned-bin streaming)."""
        return None if self._cache is None else self._cache.get(name)

    def bin_dirs(self) -> list[Path]:
        return sorted(p for p in self.dir.iterdir()
                      if p.is_dir() and p.name.startswith("bin_"))

    @staticmethod
    def load_bin(bin_dir: Path) -> FragmentBatch:
        """One-pass-sized load: header scan + preallocated output columns
        (R.concat_chunk_files) — no transient 2x-bin concat spike."""
        chunks = sorted(bin_dir.glob("chunk_*.*"))
        return R.concat_chunk_files(chunks)

    @staticmethod
    def iter_chunk_groups(bin_dir: Path, max_records: int):
        """Yield a bin's chunks concatenated into groups of at most
        ~max_records rows (always at least one whole chunk per group).

        Bounds RAM for bins that outgrew their budget — above all the
        trailing unaligned bin, which a low-quality run can fill with
        half its records (the aligned bins are budget-sized, this one is
        not).  Reference analog: Build's bin admission throttling,
        include/build/Build.hh:163-183."""
        group: list[FragmentBatch] = []
        rows = 0
        for c in sorted(bin_dir.glob("chunk_*.*")):
            fb = FragmentBatch.load(c)
            if group and rows + len(fb) > max_records:
                yield R.concat(group)
                group, rows = [], 0
            group.append(fb)
            rows += len(fb)
        if group:
            yield R.concat(group)


class DistributionBinStore:
    """Match-distribution-driven genomic binning (reference
    MatchDistribution.hh:43-107 + BinIndexMap.hh:44-96).

    The reference sizes bins from the match distribution its seed pass
    observed; the streaming workflow has no separate pass, so this store
    BUFFERS the first `sample_cap` records (at most one bin budget),
    accumulates a coarse position histogram, cuts bin boundaries at
    equal sampled record mass, then flushes the buffer and streams the
    rest.  Uniform coverage reproduces (near-)equal spans; skewed runs
    (amplicons/exomes, 90% of reads in 1% of the genome) get equal
    record mass per bin so the --memory-limit contract holds.  FASTQ/BCL
    arrive in flowcell order (position-random), so the sample is
    representative; a coordinate-sorted BAM input degrades to span cuts
    no worse than round 2's behavior."""

    SPANS = 4096

    def __init__(self, bins_dir, contig_offsets, genome_bp: int,
                 n_bins: int, sample_cap: int, ram_cache_records: int = 0,
                 pre_sort: bool = False, uniform: bool = False):
        from ..build.storage import BinnedFragmentStore
        self._mk = lambda boundaries: BinnedFragmentStore(
            bins_dir, contig_offsets, genome_bp, n_bins,
            boundaries=boundaries, ram_cache_records=ram_cache_records,
            pre_sort=pre_sort)
        self.offsets = contig_offsets
        self.genome_bp = genome_bp
        self.n_bins = max(1, n_bins)
        self.sample_cap = sample_cap
        self._span_bp = max(1, -(-genome_bp // self.SPANS))
        self._hist = np.zeros(self.SPANS, np.int64)
        self._buffer: list = []
        self._buffered = 0
        self._inner = None
        if uniform:
            # multi-host runs need IDENTICAL bin boundaries on every
            # host (each host samples a different stripe): fixed
            # equal-span cuts, no sampling
            self._inner = self._mk(None)

    def add(self, fb, seq: int | None = None) -> None:
        if self._inner is not None:
            self._inner.add(fb, seq=seq)
            return
        placed = fb.ref_id >= 0
        if placed.any():
            gpos = (self.offsets[np.maximum(fb.ref_id, 0)]
                    + fb.pos)[placed]
            np.add.at(self._hist,
                      np.minimum(gpos // self._span_bp, self.SPANS - 1), 1)
        self._buffer.append((fb, seq))
        self._buffered += len(fb)
        if self._buffered >= self.sample_cap:
            self._freeze()

    def _freeze(self) -> None:
        total = int(self._hist.sum())
        if total == 0 or self.n_bins <= 1:
            boundaries = None
        else:
            cum = np.cumsum(self._hist)
            targets = np.arange(1, self.n_bins) * total / self.n_bins
            spans = np.searchsorted(cum, np.ceil(targets), side="left") + 1
            cuts = np.minimum(spans.astype(np.int64) * self._span_bp,
                              self.genome_bp)
            boundaries = np.concatenate(
                [[0], np.maximum.accumulate(cuts)]).astype(np.int64)
        self._inner = self._mk(boundaries)
        for fb, seq in self._buffer:
            self._inner.add(fb, seq=seq)
        self._buffer = []

    def finalize(self, write_meta: bool = True) -> None:
        """Flush (small runs never hit the sample cap); persist the bin
        boundaries so the Build phase can describe each bin for
        --bin-regex filtering.  `write_meta=False` for multi-host
        non-zero processes (process 0 owns the shared metadata file)."""
        if self._inner is None:
            self._freeze()
        inner = self._inner
        if not write_meta:
            return
        doc = {"bin_bp": int(inner.bin_bp), "n_bins": int(inner.n_bins)}
        if inner.boundaries is not None:
            doc["boundaries"] = [int(x) for x in inner.boundaries]
        (inner.dir / "boundaries.json").write_text(json.dumps(doc))

    def cached_bin(self, name: str):
        return self._inner.cached_bin(name) if self._inner else None

    def cached_chunks(self, name: str):
        return self._inner.cached_chunks(name) if self._inner else None

    @property
    def records(self) -> int:
        # the flushed buffer re-counts through the inner store
        return self._inner.records if self._inner else self._buffered

