"""Host drivers: read batches in, SAM records out.

Port of `isaac_aligner_tpu/aligner.py`: the single-end `Aligner` and the
paired-end `PairedAligner`.  `create(index, read_len, device=...)` uploads
the index planes to the device; each batch then runs the torch pipeline
(`align_batch`, or `align_paired_batch` for pairs) on that device, comes
to the host with one `.cpu()` per result field, and goes through the host
polish passes in the JAX driver's order: quality trim masks, (pairs:
shadow and disjoined rescue on the device), masked tail, contig-end clip,
gapped polish (banded SW on the device, once per end), long-indel polish,
semialigned clip, (pairs: overlapping-end clip).

On a card, a batch's device program (everything `_dispatch` enqueues after
the host's adapter mask) is captured as a CUDA graph at its key's second
sight and replayed after that (`graphs.ProgramGraphs`); the counters
`graph_replays`, `graph_captures` and `eager_dispatches` say which path
each batch took.

Batches run in order.  The JAX driver's single-buffer result packing, its
fetch worker threads and its fixed-capacity rescue calls existed for the
TPU link's per-fetch latency and static shapes, and are left behind.

`create(..., defer_upload=True)` leaves the planes on the host until
`ensure_uploaded()`; `release_device()` drops them and returns their
memory to the card (group-major runs over contig-group references,
`parallel/multi_index.py`).
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

from . import dna
from .align import clippers
from .align import tls as tls_mod
from .align.gapped import BWA, GapScoring, cigar_stats, polish_gapped
from .align.indel import polish_simple_indels
from .align.pairs import (TlsStatic, align_paired_batch,
                          quantize_rescue_window, rescue_shadows)
from .align.pipeline import (AlignConfig, IndexArrays, align_batch,
                             bucket_params_for, default_seed_offsets,
                             genome_has_n_for, mask_tail_device, prepare_index,
                             score_end)
from .device import require_device
from .graphs import ProgramGraphs
from .graphs import upload as _upload
from .index.build import SeedIndex
from .io import sam
from .io.fastq import ReadBatch
from .ops import sw
from .utils import tracing


def _accumulate_finder_stats(acc: dict, res: dict) -> None:
    """Tally MatchFinder-style seed outcome scalars out of a result dict
    (both ends of a pair summed), plus one per-batch tally entry
    (reference MatchTally)."""
    tally = {}
    for key in ("seeds_no_match", "seeds_too_many", "pass2_reads",
                "pass2_dropped"):
        for k in (key, key + "_1", key + "_2"):
            if k in res:
                acc[key] = acc.get(key, 0) + int(res[k])
                tally[key] = tally.get(key, 0) + int(res[k])
    if tally:
        acc.setdefault("tally", []).append(tally)


def _pad_to_seed(bases: np.ndarray, quals: np.ndarray, seed_len: int):
    """Widen a batch narrower than the seed with N columns: its seeds all
    carry N and the reads come out unmapped instead of failing."""
    b, l = bases.shape
    if l >= seed_len:
        return bases, quals
    pb = np.full((b, seed_len), 4, np.uint8)
    pq = np.zeros((b, seed_len), np.uint8)
    pb[:, :l] = bases
    pq[:, :l] = quals
    return pb, pq


def _fetch(out: dict, device) -> dict[str, np.ndarray]:
    """The device results on the host, one .cpu() per field, as the span
    `fetch`: `fetch.wait` waits for the work queued on the device's
    current stream (CUDA only; the copies would wait for it all the
    same), `fetch.copy` is the copies.  Stream order makes one wait cover
    everything queued before it: in the resident grouped path
    (`parallel/multi_index.py`) group 0's wait also covers the later
    groups' queued work."""
    with tracing.span("fetch"):
        with tracing.span("fetch.wait"):
            if device.type == "cuda":
                torch.cuda.current_stream(device).synchronize()
        with tracing.span("fetch.copy"):
            return {k: v.cpu().numpy() for k, v in out.items()}


def _check_read_len(read_len: int | None, device) -> None:
    """The CUDA SW kernel's length limit shows at create, not at the first
    gapped polish."""
    if (torch.device(device).type == "cuda" and read_len is not None
            and read_len > sw.MAX_LEN):
        raise ValueError(f"read_len {read_len} > {sw.MAX_LEN}, the longest "
                         f"read the CUDA banded SW kernel takes")


def _with_bucket_log2(cfg: AlignConfig, index: SeedIndex) -> AlignConfig:
    """Fill in static index-derived parameters: index seed length, genome
    length, bucket table and the genome's N flag."""
    if index.seed_len == 64 and cfg.seed_len != 64:
        raise ValueError(
            f"a 64-mer LongKmerType index only supports 64-mer seeds "
            f"(cfg.seed_len={cfg.seed_len}); build a 16/32-mer index for "
            f"shorter seeds")
    if cfg.index_seed_len is None:
        cfg = dataclasses.replace(cfg, index_seed_len=index.seed_len)
    if cfg.genome_len == 0:
        cfg = dataclasses.replace(cfg, genome_len=index.genome.total_length)
    if cfg.bucket_log2 is not None:
        return cfg
    width, log2 = bucket_params_for(index)
    return dataclasses.replace(cfg, bucket_width=width, bucket_log2=log2,
                               genome_has_n=genome_has_n_for(index))


@dataclasses.dataclass
class Aligner:
    index: SeedIndex
    arrays: IndexArrays | None      # None while the planes are not uploaded
    cfg: AlignConfig
    device: torch.device
    # clipping options (reference defaults: AlignOptions.cpp:109,119-120)
    base_quality_cutoff: int = 25
    clip_semialigned: bool = True
    adapters: tuple[str, ...] = ()
    gap_scoring: GapScoring = BWA
    # reference --gapped-mismatches (=5): mismatch count that triggers SW
    gapped_mismatches: int = 5
    # reference --avoid-smith-waterman: 7-mer pre-filter before SW polish
    avoid_smith_waterman: bool = False
    # reference --semialigned-gap-limit (=100; 0 disables)
    semialigned_gap_limit: int = 100
    # accumulated MatchFinder-style seed stats
    finder_stats: dict = dataclasses.field(default_factory=dict)
    # wall seconds per stage span (utils/tracing.span): upload, dispatch,
    # fetch, polish, stats, records and their dotted children
    timings: dict = dataclasses.field(default_factory=dict)
    # (query, window) pairs sent to the banded SW kernel, and those whose
    # gapped result replaced the ungapped one
    sw_pairs: int = 0
    sw_accepted: int = 0
    # what the polish passes changed: ends quality-trimmed,
    # semialigned-clipped, re-clipped on the host after a rescue moved them
    # (pairs), overlap-clipped (pairs), realigned by the simple-indel
    # aligner, and pairs whose fields a move of an end changed (pairs)
    trimmed_ends: int = 0
    semialigned_clipped: int = 0
    reclipped: int = 0
    overlap_clipped: int = 0
    indel_moved: int = 0
    indel_repaired: int = 0
    # how each batch's device program ran (graphs.ProgramGraphs): replayed
    # as a CUDA graph, captured, or enqueued op by op
    graph_replays: int = 0
    graph_captures: int = 0
    eager_dispatches: int = 0
    graphs: ProgramGraphs = dataclasses.field(default_factory=ProgramGraphs,
                                              repr=False, compare=False)

    def ensure_uploaded(self) -> None:
        """Upload the index planes to the device if they are not there;
        the seconds it takes (to the end of the copies) add to
        timings["upload"]."""
        if self.arrays is None:
            with tracing.collect(self.timings), tracing.span("upload"):
                self.arrays = prepare_index(self.index, self.device,
                                            upload_codes=False)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)

    def release_device(self) -> None:
        """Drop the device planes, and the graphs that read them, and
        return their memory to the card, so that the next contig group's
        upload can take it."""
        self.graphs.clear()
        self.arrays = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    @staticmethod
    def create(index: SeedIndex, read_len: int | None = None,
               cfg: AlignConfig | None = None, *, device="cuda",
               defer_upload: bool = False, **opts) -> "Aligner":
        """Aligner on `device` ("cuda" by default, "cuda:N" or "cpu";
        "cuda" without a card raises, as do reads longer than the SW
        kernel's `sw.MAX_LEN` on a card).  With `defer_upload` the planes
        stay on the host until `ensure_uploaded()`."""
        _check_read_len(read_len, device)
        dev = require_device(device)
        if cfg is None:
            offsets = default_seed_offsets(read_len or index.seed_len,
                                           index.seed_len)
            cfg = AlignConfig(seed_len=index.seed_len, seed_offsets=offsets)
        cfg = _with_bucket_log2(cfg, index)
        al = Aligner(index=index, cfg=cfg, device=dev, arrays=None, **opts)
        if not defer_upload:
            al.ensure_uploaded()
        # quality trim + semialigned clip run on the device
        al.cfg = dataclasses.replace(
            cfg, quality_trim_cutoff=al.base_quality_cutoff,
            semialigned_clip=al.clip_semialigned)
        return al

    def _dispatch(self, batch: ReadBatch):
        """Adapter-mask on host, enqueue the device pipeline (replayed as a
        CUDA graph where it can be: `graphs.ProgramGraphs`)."""
        with tracing.collect(self.timings), tracing.span("dispatch"):
            bases = batch.bases.copy()
            quals = batch.quals.copy()
            trims = clippers.adapter_trim_batch(bases, quals,
                                                list(self.adapters))
            bases, quals = _pad_to_seed(bases, quals, self.cfg.seed_len)
            # the device gets the original bases and re-applies the adapter
            # mask from the counts; the masked host copies feed the polish
            ob, oq = _pad_to_seed(batch.bases, batch.quals, self.cfg.seed_len)
            out = self.graphs.run(self.cfg, self._program(),
                                  (ob, oq, trims.astype(np.int32)),
                                  self.device, self.arrays, self)
            return out, bases, quals, trims, batch

    def _program(self):
        """The batch's device program on its device inputs (original
        bases, qualities and adapter counts): everything `_dispatch`
        enqueues after the host's adapter mask."""
        arrays, cfg = self.arrays, self.cfg

        def program(ob, oq, tail):
            mb, mq = mask_tail_device(ob, oq, tail)
            return align_batch(arrays, mb, mq, cfg, tail)
        return program

    def _finish(self, pending) -> dict[str, np.ndarray]:
        """Fetch device results (one .cpu() per field), run host polish."""
        out, bases, quals, trims, batch = pending
        with tracing.collect(self.timings):
            res = _fetch(out, self.device)
            with tracing.span("polish"):
                with tracing.span("polish.clip"):
                    with tracing.span("polish.clip.trim"):
                        qtrim = res.pop("qtrim")
                        self.trimmed_ends += int(np.count_nonzero(qtrim))
                        total_trims = clippers.apply_quality_trim_masks(
                            bases, quals, trims, qtrim)
                        masked = clippers.apply_masked_tail_cigar(
                            res, "", total_trims, batch.read_len)
                    clippers.clip_contig_ends(res, "", self.index.genome,
                                              batch.read_len)
                with tracing.span("polish.gapped"):
                    self.sw_pairs += polish_gapped(
                        self.index, self.cfg, res, bases, self.device,
                        quals=quals, gs=self.gap_scoring,
                        trigger=self.gapped_mismatches,
                        avoid_sw=self.avoid_smith_waterman, tally=self,
                        masked=masked)
                with tracing.span("polish.indel"):
                    moved = polish_simple_indels(
                        self.index, self.cfg, res, bases, quals=quals,
                        gs=self.gap_scoring,
                        trigger=max(6, self.gapped_mismatches + 1),
                        max_gap=self.semialigned_gap_limit)
                    self.indel_moved += int(moved.size)
                if self.clip_semialigned:
                    with tracing.span("polish.clip"), \
                            tracing.span("polish.clip.semialigned"):
                        self.semialigned_clipped += \
                            clippers.apply_semialigned_device(
                                res, "", bases.shape[1],
                                self.index.genome.codes, bases)
        return res

    def _record_stats(self, batch: ReadBatch, res: dict) -> None:
        with tracing.collect(self.timings), tracing.span("stats"):
            _accumulate_finder_stats(self.finder_stats, res)
            tracing.trace_batch(batch.names, res)

    def align_batch_arrays(self, batch: ReadBatch) -> dict[str, np.ndarray]:
        """Run the device pipeline; returns host numpy result arrays."""
        res = self._finish(self._dispatch(batch))
        self._record_stats(batch, res)
        return res

    def align_results_many(self, batches):
        """Align batch after batch in order; yields (batch, result arrays)."""
        for batch in batches:
            yield batch, self.align_batch_arrays(batch)

    def align_to_sam_many(self, batches, phred_offset: int = 33):
        """Yields one SamRecord list per batch."""
        for batch, res in self.align_results_many(batches):
            yield self._records_from_res(batch, res, phred_offset)

    def align_to_sam(self, batch: ReadBatch,
                     phred_offset: int = 33) -> list[sam.SamRecord]:
        res = self.align_batch_arrays(batch)
        return self._records_from_res(batch, res, phred_offset)

    def _records_from_res(self, batch: ReadBatch, res: dict,
                          phred_offset: int = 33) -> list[sam.SamRecord]:
        genome = self.index.genome
        records: list[sam.SamRecord] = []
        with tracing.collect(self.timings), tracing.span("records"):
            for i, name in enumerate(batch.names):
                if name.startswith("__pad"):
                    continue
                length = int(batch.lengths[i])
                bases = batch.bases[i, :length]
                quals = batch.quals[i, :length]
                aligned = bool(res["aligned"][i])
                reverse = bool(res["reverse"][i])
                if aligned and reverse:
                    seq = dna.decode(dna.revcomp(bases))
                    qual = "".join(chr(int(q) + phred_offset)
                                   for q in quals[::-1])
                else:
                    seq = dna.decode(bases)
                    qual = "".join(chr(int(q) + phred_offset) for q in quals)
                if aligned:
                    contig, local = genome.to_local(int(res["start"][i]))
                    cigars = res.get("cigar")
                    cigar = (cigars[i] if cigars and cigars[i]
                             else f"{length}M")
                    rec = sam.SamRecord(
                        qname=name,
                        flag=sam.FLAG_REVERSE if reverse else 0,
                        rname=contig,
                        pos=local + 1,
                        mapq=int(res["mapq"][i]),
                        cigar=cigar,
                        seq=seq,
                        qual=qual,
                    )
                    rec.set_tag("NM", "i", int(res["edit_distance"][i]))
                    rec.set_tag("SM", "i", int(res["mapq"][i]))
                else:
                    rec = sam.SamRecord(
                        qname=name, flag=sam.FLAG_UNMAPPED, rname="*", pos=0,
                        mapq=0, cigar="*", seq=seq, qual=qual,
                    )
                records.append(rec)
        return records


# ---------------------------------------------------------------------------
# Paired-end driver
# ---------------------------------------------------------------------------

#: elements of the largest rescue temporaries ([rows, window, read_len],
#: 256 MiB in float64) per rescue call: rows are independent, so the chunk
#: size changes memory only, never the result
RESCUE_CHUNK_ELEMS = 1 << 25


@dataclasses.dataclass
class PairedAligner:
    """Paired-end alignment with TLS learning and shadow rescue.

    Reference analog: MatchSelector::determineTemplateLength +
    TemplateBuilder::buildTemplate.  `learn_tls()` over representative
    batches first (or set `tls`), then `align_to_sam(batch1, batch2)`.
    """

    index: SeedIndex
    arrays: IndexArrays | None      # None while the planes are not uploaded
    cfg: AlignConfig
    device: torch.device
    tls: TlsStatic = dataclasses.field(default_factory=TlsStatic)
    max_rescue_window: int = 4096   # skip rescue when the TLS window exceeds this
    # reference --shadow-scan-range (=-1): -1 scans the full template
    # min..max window; >= 0 scans median +- range (manual.md:524-527)
    shadow_scan_range: int = -1
    # reference --gapped-mismatches / --semialigned-gap-limit /
    # --avoid-smith-waterman (see Aligner)
    gapped_mismatches: int = 5
    semialigned_gap_limit: int = 100
    avoid_smith_waterman: bool = False
    # clipping options (reference defaults: AlignOptions.cpp:109,119-120)
    base_quality_cutoff: int = 25
    clip_semialigned: bool = True
    clip_overlapping: bool = True
    adapters: tuple[str, ...] = ()
    gap_scoring: GapScoring = BWA
    # reference --bam-pessimistic-mapq (manual.md:279)
    pessimistic_mapq: bool = False
    finder_stats: dict = dataclasses.field(default_factory=dict)
    # wall seconds per stage span, as Aligner's (polish.rescue inside
    # polish)
    timings: dict = dataclasses.field(default_factory=dict)
    # (query, window) pairs sent to the banded SW kernel, and those whose
    # gapped result replaced the ungapped one
    sw_pairs: int = 0
    sw_accepted: int = 0
    # orphan rows scanned by rescue_shadows, and its calls
    rescue_rows: int = 0
    rescue_calls: int = 0
    # the polish passes' counters, as Aligner's
    trimmed_ends: int = 0
    semialigned_clipped: int = 0
    reclipped: int = 0
    overlap_clipped: int = 0
    indel_moved: int = 0
    indel_repaired: int = 0
    # how each batch's device program ran, as Aligner's
    graph_replays: int = 0
    graph_captures: int = 0
    eager_dispatches: int = 0
    graphs: ProgramGraphs = dataclasses.field(default_factory=ProgramGraphs,
                                              repr=False, compare=False)

    ensure_uploaded = Aligner.ensure_uploaded
    release_device = Aligner.release_device

    @staticmethod
    def create(index: SeedIndex, read_len: int | None = None,
               cfg: AlignConfig | None = None, *, device="cuda",
               defer_upload: bool = False, **opts) -> "PairedAligner":
        """Paired aligner on `device` ("cuda" by default, "cuda:N" or
        "cpu"; "cuda" without a card raises).  With `defer_upload` the
        planes stay on the host until `ensure_uploaded()`."""
        _check_read_len(read_len, device)
        dev = require_device(device)
        if cfg is None:
            offsets = default_seed_offsets(read_len or index.seed_len,
                                           index.seed_len)
            cfg = AlignConfig(seed_len=index.seed_len, seed_offsets=offsets)
        cfg = _with_bucket_log2(cfg, index)
        al = PairedAligner(index=index, cfg=cfg, device=dev, arrays=None,
                           **opts)
        if not defer_upload:
            al.ensure_uploaded()
        # quality trim + semialigned clip run on the device; rescued
        # shadows get the host semialigned pass (they were unaligned when
        # the device clip ran)
        al.cfg = dataclasses.replace(
            cfg, quality_trim_cutoff=al.base_quality_cutoff,
            semialigned_clip=al.clip_semialigned)
        return al

    # -- TLS learning -------------------------------------------------------

    def learn_tls(self, batches) -> TlsStatic:
        """Learn template-length statistics from uniquely aligning pairs
        (TemplateLengthDistribution::addTemplate semantics): both ends with
        exactly one candidate, on the same contig."""
        learner = tls_mod.TemplateLengthLearner()
        offsets = self.index.genome.contig_offsets
        for b1, b2 in batches:
            rows = []
            for b in (b1, b2):
                end = self._score_end(b)
                rows += [end["num_candidates"].to(torch.int64),
                         end["start"][:, 0].to(torch.int64),
                         end["orient"][:, 0].to(torch.int64)]
            n1, s1, o1, n2, s2, o2 = torch.stack(rows).cpu().numpy()
            cid1 = np.searchsorted(offsets, s1, side="right") - 1
            cid2 = np.searchsorted(offsets, s2, side="right") - 1
            use = (n1 == 1) & (n2 == 1) & (cid1 == cid2)
            learner.add_batch(s1, o1 == 1, b1.read_len, s2, o2 == 1,
                              b2.read_len, use)
        stats = learner.finalize()
        self.tls = TlsStatic.from_stats(stats)
        return self.tls

    def _score_end(self, batch: ReadBatch) -> dict:
        """Scored candidate lists of one end's raw batch (TLS learning)."""
        return score_end(self.arrays, self.cfg,
                         _upload(batch.bases, self.device),
                         _upload(batch.quals, self.device))

    # -- alignment ----------------------------------------------------------

    def _dispatch(self, b1: ReadBatch, b2: ReadBatch):
        """Adapter-mask both ends on the host, enqueue the device pipeline
        (quality trim and semialigned clip run on the device; replayed as
        a CUDA graph where it can be: `graphs.ProgramGraphs`)."""
        with tracing.collect(self.timings), tracing.span("dispatch"):
            masked, inputs, trims = [], [], []
            for b in (b1, b2):
                bases = b.bases.copy()
                quals = b.quals.copy()
                t = clippers.adapter_trim_batch(bases, quals,
                                                list(self.adapters))
                bases, quals = _pad_to_seed(bases, quals, self.cfg.seed_len)
                masked.append(ReadBatch(b.names, bases, quals, b.lengths))
                ob, oq = _pad_to_seed(b.bases, b.quals, self.cfg.seed_len)
                inputs += [ob, oq, t.astype(np.int32)]
                trims.append(t)
            # the device gets the original bases and re-applies the adapter
            # mask from the counts; the masked host copies feed polish +
            # rescue
            tls = self._batch_tls(b1)
            out = self.graphs.run((self.cfg, tls), self._program(tls),
                                  tuple(inputs), self.device, self.arrays,
                                  self)
            return out, masked[0], masked[1], trims, (b1, b2)

    def _program(self, tls: TlsStatic):
        """The batch's device program on its six device inputs (each end's
        original bases, qualities and adapter counts) under the TLS model
        `tls`: everything `_dispatch` enqueues after the host's adapter
        mask."""
        arrays, cfg = self.arrays, self.cfg

        def program(ob1, oq1, tail1, ob2, oq2, tail2):
            mb1, mq1 = mask_tail_device(ob1, oq1, tail1)
            mb2, mq2 = mask_tail_device(ob2, oq2, tail2)
            return align_paired_batch(arrays, mb1, mq1, mb2, mq2, cfg, tls,
                                      tail1, tail2)
        return program

    def _finish(self, pending) -> dict[str, np.ndarray]:
        """Fetch device results (one .cpu() per field), run the host
        passes: rescue, clips and both ends' polish."""
        out, m1, m2, trims, (b1, b2) = pending
        with tracing.collect(self.timings):
            res = _fetch(out, self.device)
            with tracing.span("polish"):
                self._polish(res, m1, m2, trims, b1, b2)
        return res

    def _polish(self, res, m1, m2, trims, b1, b2) -> None:
        """The host passes of `_finish`, each a child span of `polish`.
        Each pass works on the alignment the one before it kept: the
        device semialigned clip only on ends still at the placement it was
        computed for (a rescued end gets the host clip), and with the
        simple-indel aligner on, the pair's fields follow an end that it or
        the gapped polish placed anew."""
        with tracing.span("polish.clip"), tracing.span("polish.clip.trim"):
            qt1, qt2 = res.pop("qtrim_1"), res.pop("qtrim_2")
            self.trimmed_ends += int(np.count_nonzero(qt1)
                                     + np.count_nonzero(qt2))
            total1 = clippers.apply_quality_trim_masks(
                m1.bases, m1.quals, trims[0], qt1)
            total2 = clippers.apply_quality_trim_masks(
                m2.bases, m2.quals, trims[1], qt2)
        with tracing.span("polish.rescue"):
            aligned_before = (res["aligned_1"].copy(), res["aligned_2"].copy())
            rescued1, rescued2 = self._apply_rescue(res, m1, m2)
        with tracing.span("polish.clip"):
            with tracing.span("polish.clip.trim"):
                masked = (clippers.apply_masked_tail_cigar(
                              res, "_1", total1, b1.read_len),
                          clippers.apply_masked_tail_cigar(
                              res, "_2", total2, b2.read_len))
            clippers.clip_contig_ends(res, "_1", self.index.genome,
                                      b1.read_len)
            clippers.clip_contig_ends(res, "_2", self.index.genome,
                                      b2.read_len)
        gs = self.gap_scoring
        trig = self.gapped_mismatches
        # the rows the gapped polish realigned
        gapped = []
        for sfx, m, t in (("_1", m1, masked[0]), ("_2", m2, masked[1])):
            with tracing.span("polish.gapped"):
                self.sw_pairs += polish_gapped(
                    self.index, self.cfg, res, m.bases, self.device, sfx,
                    quals=m.quals, gs=gs, trigger=trig,
                    avoid_sw=self.avoid_smith_waterman, tally=self,
                    masked=t, accepted=gapped)
        moved = []
        for sfx, m in (("_1", m1), ("_2", m2)):
            with tracing.span("polish.indel"):
                moved.append(polish_simple_indels(
                    self.index, self.cfg, res, m.bases, sfx, quals=m.quals,
                    gs=gs, trigger=max(6, trig + 1),
                    max_gap=self.semialigned_gap_limit))
        self.indel_moved += int(moved[0].size + moved[1].size)
        if self.semialigned_gap_limit > 0:
            # the pair step's fields of every pair with an end that the
            # gapped polish or the simple-indel aligner placed anew (with
            # the simple-indel aligner off, they stay the pair step's, as
            # in the JAX package)
            with tracing.span("polish.indel"), \
                    tracing.span("polish.indel.repair"):
                rows = np.union1d(np.asarray(gapped, np.int64),
                                  np.union1d(*moved))
                if rows.size:
                    self.indel_repaired += self._repair_pairs(res, rows,
                                                              b1, b2)
        g_codes = self.index.genome.codes
        with tracing.span("polish.clip"):
            if self.clip_semialigned:
                with tracing.span("polish.clip.semialigned"):
                    self._clip_semialigned(res, g_codes, (m1, m2), (b1, b2),
                                           (rescued1, rescued2),
                                           aligned_before)
            if self.clip_overlapping:
                with tracing.span("polish.clip.overlap"):
                    self.overlap_clipped += clippers.clip_overlapping(
                        res, m1, m2, g_codes)

    def _clip_semialigned(self, res, g_codes, masked, batches, rescued,
                          aligned_before) -> None:
        """The semialigned clip of both ends: the device's where the end
        kept the alignment it was computed for; the host pass on ends the
        rescue placed (shadows, which the device saw unaligned, and
        disjoined ends it moved: `reclipped`)."""
        for e, (m, b, hit, was) in enumerate(
                zip(masked, batches, rescued, aligned_before), 1):
            sfx = f"_{e}"
            moved = np.nonzero(hit)[0]
            self.semialigned_clipped += clippers.apply_semialigned_device(
                res, sfx, b.read_len, g_codes, m.bases, skip_rows=moved)
            if moved.size:
                self.reclipped += int(np.count_nonzero(was[moved]))
                self.semialigned_clipped += clippers.clip_semialigned(
                    res, sfx, g_codes, m.bases, row_mask=hit)

    def _repair_pairs(self, res, rows, b1, b2) -> int:
        """Pair resolution, proper flag and template length of `rows` from
        their final placements, by the device pair step's rule
        (`pairs.resolve_pairs`: each end's unclipped start and read length,
        the batch's TLS model); a pair no longer resolved loses its
        template score.  Returns the number of pairs whose fields
        changed."""
        s = self._batch_tls(b1).to_stats()
        offs = self.index.genome.contig_offsets
        p1, p2 = (res["start" + sfx][rows].astype(np.int64)
                  - clippers.clip_spans([res["cigar" + sfx][i]
                                         for i in rows.tolist()])[0]
                  for sfx in ("_1", "_2"))
        r1 = res["reverse_1"][rows].astype(bool)
        r2 = res["reverse_2"][rows].astype(bool)
        both = res["aligned_1"][rows].astype(bool) & \
            res["aligned_2"][rows].astype(bool)
        same = np.searchsorted(offs, p1, side="right") == \
            np.searchsorted(offs, p2, side="right")
        model = tls_mod.alignment_model(p1, r1, p2, r2)
        length = tls_mod.template_length(p1, b1.read_len, p2, b2.read_len)
        in_models = (model == s.best_models[0]) | (model == s.best_models[1])
        resolved = both & same & in_models & \
            (length <= s.max + tls_mod.TEMPLATE_LENGTH_THRESHOLD)
        proper = resolved & np.asarray(s.nominal(model, length))
        tlen = np.where(resolved, length, 0)
        old = (res["pair_resolved"][rows].astype(bool),
               res["proper_pair"][rows].astype(bool),
               res["template_length"][rows].astype(np.int64))
        changed = (old[0] != resolved) | (old[1] != proper) | \
            (old[2] != tlen)
        res["pair_resolved"][rows] = resolved
        res["proper_pair"][rows] = proper
        res["template_length"][rows] = tlen
        res["template_score"][rows] = np.where(
            resolved, res["template_score"][rows], -1)
        return int(np.count_nonzero(changed))

    def _record_stats(self, b1: ReadBatch, b2: ReadBatch, res: dict) -> None:
        with tracing.collect(self.timings), tracing.span("stats"):
            _accumulate_finder_stats(self.finder_stats, res)
            # anomalous pairs (reference MatchSelectorStats): both ends
            # aligned but no proper pair even after disjoined rescue
            both = res["aligned_1"] & res["aligned_2"]
            self.finder_stats["anomalous_pairs"] = \
                self.finder_stats.get("anomalous_pairs", 0) \
                + int((both & ~res["proper_pair"]).sum())
            n_skip = int(res.get("rescue_skipped_count", 0))
            if n_skip:
                if not self.finder_stats.get("rescue_skipped"):
                    tracing.log(
                        f"shadow rescue DISABLED: TLS window "
                        f"{self._rescue_window()} exceeds max_rescue_window "
                        f"{self.max_rescue_window}; orphaned mates stay "
                        f"unaligned", force=True)
                self.finder_stats["rescue_skipped"] = \
                    self.finder_stats.get("rescue_skipped", 0) + n_skip
            tracing.trace_batch(b1.names, res, "_1")
            tracing.trace_batch(b2.names, res, "_2")

    def align_batch_arrays(self, b1: ReadBatch,
                           b2: ReadBatch) -> dict[str, np.ndarray]:
        res = self._finish(self._dispatch(b1, b2))
        self._record_stats(b1, b2, res)
        return res

    def align_results_many(self, batches):
        """Align (b1, b2) batch after batch in order; yields ((b1, b2),
        result arrays)."""
        for b1, b2 in batches:
            yield (b1, b2), self.align_batch_arrays(b1, b2)

    def align_to_sam_many(self, batches, phred_offset: int = 33):
        """Yields one SamRecord list per (b1, b2) batch."""
        for (b1, b2), res in self.align_results_many(batches):
            yield self._records_from_res(b1, b2, res, phred_offset)

    def align_to_sam(self, b1: ReadBatch, b2: ReadBatch,
                     phred_offset: int = 33) -> list[sam.SamRecord]:
        res = self.align_batch_arrays(b1, b2)
        return self._records_from_res(b1, b2, res, phred_offset)

    # -- rescue -------------------------------------------------------------

    def _batch_tls(self, b1) -> TlsStatic:
        """The TLS model of one batch: a per-tile hint riding the batch, or
        the global model.  Plain ints, read afresh for every batch."""
        return getattr(b1, "tls_hint", None) or self.tls

    def _rescue_tls(self, tls: TlsStatic | None = None) -> TlsStatic:
        """TLS of the rescue window: --shadow-scan-range >= 0 clamps the
        scan to median +- range without touching the pairing model."""
        t = tls or self.tls
        if self.shadow_scan_range < 0:
            return t
        return dataclasses.replace(
            t, mate_min=max(t.mate_min, t.median - self.shadow_scan_range),
            mate_max=min(t.mate_max, t.median + self.shadow_scan_range))

    def _rescue_window(self, tls: TlsStatic | None = None) -> int:
        t = self._rescue_tls(tls)
        return quantize_rescue_window(t.mate_max - t.mate_min + 1,
                                      self.max_rescue_window)

    def _dispatch_rescue_chunks(self, res, rows, orphan_end, shadow_batch,
                                read_lengths, window, tls: TlsStatic):
        """Enqueue the rescue over `rows` in chunks of at most
        RESCUE_CHUNK_ELEMS window elements; returns the chunks' device
        result dicts without fetching them."""
        per_call = max(1, RESCUE_CHUNK_ELEMS
                       // (window * shadow_batch.bases.shape[1]))
        rescue_tls = self._rescue_tls(tls)
        pend = []
        for lo in range(0, rows.size, per_call):
            rr = rows[lo : lo + per_call]
            self.rescue_rows += rr.size
            self.rescue_calls += 1
            pend.append(rescue_shadows(
                self.arrays, self.cfg, rescue_tls, orphan_end - 1,
                read_lengths,
                _upload(res[f"start_{orphan_end}"][rr], self.device),
                _upload(res[f"reverse_{orphan_end}"][rr], self.device),
                _upload(shadow_batch.bases[rr], self.device),
                _upload(shadow_batch.quals[rr], self.device), window))
        return pend

    @staticmethod
    def _fetch_rescue_chunks(pend) -> dict[str, np.ndarray]:
        outs = [{k: v.cpu().numpy() for k, v in o.items()} for o in pend]
        return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}

    def _apply_rescue(self, res, b1: ReadBatch, b2: ReadBatch):
        """Shadow and disjoined-template rescue, merged into the result.

        Shadow rows (one end unaligned): TemplateBuilder::rescueShadow.
        Disjoined rows (both ends aligned, no TLS-compatible pair): a
        rescue anchored at each end's best candidate, adopting the better
        rescued template by (summed mismatches, then summed log
        probability), direction 1 winning ties (buildDisjoinedTemplate,
        TemplateBuilder.cpp:716-866).  Every site is enqueued on the
        device before the first fetch.  Returns per-end masks of the
        rescued rows (the host semialigned clip covers them)."""
        n_rows = res["aligned_1"].shape[0]
        rescued = {1: np.zeros(n_rows, bool), 2: np.zeros(n_rows, bool)}
        tls = self._batch_tls(b1)
        window = self._rescue_window(tls)
        disjoined = res.get("disjoined")
        if disjoined is None:
            disjoined = np.zeros(n_rows, bool)
        if window > self.max_rescue_window:
            # not silent: _record_stats logs and counts the stranded rows
            res["rescue_skipped_count"] = int(
                res["shadow_1"].sum() + res["shadow_2"].sum()
                + disjoined.sum())
            return rescued[1], rescued[2]
        read_lengths = (b1.read_len, b2.read_len)
        shadow_pend = {}
        for shadow_end, orphan_end in ((1, 2), (2, 1)):
            rows = np.nonzero(res[f"shadow_{shadow_end}"])[0]
            if rows.size == 0:
                continue
            shadow_batch = b1 if shadow_end == 1 else b2
            shadow_pend[shadow_end] = (rows, self._dispatch_rescue_chunks(
                res, rows, orphan_end, shadow_batch, read_lengths,
                window, tls))
        d_rows = np.nonzero(disjoined)[0]
        dis_pend = {}
        if d_rows.size:
            for orphan_end in (1, 2):
                shadow_batch = b1 if (3 - orphan_end) == 1 else b2
                dis_pend[orphan_end] = self._dispatch_rescue_chunks(
                    res, d_rows, orphan_end, shadow_batch, read_lengths,
                    window, tls)

        for shadow_end, (rows, pend) in shadow_pend.items():
            out = self._fetch_rescue_chunks(pend)
            hit = self._merge_rescue(res, rows, shadow_end, 3 - shadow_end,
                                     out, read_lengths, tls)
            rescued[shadow_end][hit] = True

        if d_rows.size:
            outs = {}
            keys = {}
            for orphan_end in (1, 2):
                o = self._fetch_rescue_chunks(dis_pend[orphan_end])
                outs[orphan_end] = o
                mm_o = res[f"mismatches_{orphan_end}"][d_rows].astype(np.float64)
                lp_o = res[f"log_prob_{orphan_end}"][d_rows].astype(np.float64)
                key = (mm_o + o["mismatches"]) * 1e5 - (lp_o + o["log_prob"])
                keys[orphan_end] = np.where(o["found"], key, np.inf)
            # direction 1 wins ties (the reference's orphan-index scan
            # order with strict improvement)
            use2 = keys[2] < keys[1]
            for orphan_end, sel_dir in ((1, ~use2), (2, use2)):
                o = dict(outs[orphan_end])
                o["found"] = o["found"] & sel_dir
                shadow_end = 3 - orphan_end
                hit = self._merge_rescue(res, d_rows, shadow_end, orphan_end,
                                         o, read_lengths, tls)
                rescued[shadow_end][hit] = True
                disjoined[hit] = False
            res["disjoined"] = disjoined
        return rescued[1], rescued[2]

    def _merge_rescue(self, res, rows, shadow_end, orphan_end, out,
                      read_lengths, tls: TlsStatic | None = None
                      ) -> np.ndarray:
        found = out["found"]
        hit = rows[found]
        if hit.size == 0:
            return hit
        se = f"_{shadow_end}"
        res["aligned" + se][hit] = True
        res["start" + se][hit] = out["start"][found]
        res["reverse" + se][hit] = out["reverse"][found]
        res["mismatches" + se][hit] = out["mismatches"][found]
        res["edit_distance" + se][hit] = out["edit_distance"][found]
        res["log_prob" + se][hit] = out["log_prob"][found]
        res["shadow" + se][hit] = False
        # the rescued pair's score, computed with the rescue (log space)
        score = out["score"][found].astype(np.int64)
        res["frag_score" + se][hit] = score
        res["template_score"][hit] = score
        # pair geometry
        s = (tls or self.tls).to_stats()
        p1 = res["start_1"][hit]; p2 = res["start_2"][hit]
        r1 = res["reverse_1"][hit]; r2 = res["reverse_2"][hit]
        model = tls_mod.alignment_model(p1, r1, p2, r2)
        length = tls_mod.template_length(p1, read_lengths[0], p2,
                                         read_lengths[1])
        res["pair_resolved"][hit] = True
        res["proper_pair"][hit] = np.asarray(s.nominal(model, length))
        res["template_length"][hit] = length
        return hit

    # -- SAM ----------------------------------------------------------------

    def _records_from_res(self, b1: ReadBatch, b2: ReadBatch, res: dict,
                          phred_offset: int = 33) -> list[sam.SamRecord]:
        genome = self.index.genome
        records: list[sam.SamRecord] = []
        with tracing.collect(self.timings), tracing.span("records"):
            for i in range(b1.count):
                name = b1.names[i]
                if name.startswith("__pad"):
                    continue
                records.extend(_pair_records(
                    genome, res, i, name, b1, b2, phred_offset,
                    self.cfg.mapq_cap, pessimistic=self.pessimistic_mapq))
        return records


def _pair_records(genome, res, i, name, b1, b2, phred_offset, mapq_cap,
                  pessimistic: bool = False):
    """The two SAM records of one pair (FragmentAccessorBamAdapter field
    mapping, including the proper-pair MAPQ max rule at :250)."""
    out = []
    ends = []
    for e, batch in ((1, b1), (2, b2)):
        length = int(batch.lengths[i])
        bases = batch.bases[i, :length]
        quals = batch.quals[i, :length]
        aligned = bool(res[f"aligned_{e}"][i])
        reverse = bool(res[f"reverse_{e}"][i]) if aligned else False
        cigars = res.get(f"cigar_{e}")
        cigar_str = cigars[i] if cigars and cigars[i] else f"{length}M"
        obs_len = length
        if aligned and cigars and cigars[i]:
            parsed = [(int(n), op)
                      for n, op in re.findall(r"(\d+)([MIDS])", cigar_str)]
            obs_len = cigar_stats(parsed)[0]
        ends.append({
            "aligned": aligned, "reverse": reverse, "length": length,
            "start": int(res[f"start_{e}"][i]) if aligned else -1,
            "frag_score": int(res[f"frag_score_{e}"][i]) if aligned else 0,
            "nm": int(res[f"edit_distance_{e}"][i]) if aligned else 0,
            "bases": bases, "quals": quals,
            "cigar": cigar_str, "obs_len": obs_len,
        })
    proper = bool(res["proper_pair"][i]) and ends[0]["aligned"] \
        and ends[1]["aligned"]
    tscore = int(res["template_score"][i])
    # template length from the post-polish positions and observed spans
    tlen_mag = 0
    if ends[0]["aligned"] and ends[1]["aligned"]:
        c0 = genome.contig_of(ends[0]["start"]).index
        c1 = genome.contig_of(ends[1]["start"]).index
        if c0 == c1:
            tlen_mag = int(tls_mod.template_length(
                ends[0]["start"], ends[0]["obs_len"],
                ends[1]["start"], ends[1]["obs_len"]))

    for e_idx, e in enumerate((1, 2)):
        me = ends[e_idx]
        mate = ends[1 - e_idx]
        flag = sam.FLAG_PAIRED | (sam.FLAG_READ1 if e == 1 else sam.FLAG_READ2)
        if proper:
            flag |= sam.FLAG_PROPER_PAIR
        if not me["aligned"]:
            flag |= sam.FLAG_UNMAPPED
        if not mate["aligned"]:
            flag |= sam.FLAG_MATE_UNMAPPED
        if me["aligned"] and me["reverse"]:
            flag |= sam.FLAG_REVERSE
        if mate["aligned"] and mate["reverse"]:
            flag |= sam.FLAG_MATE_REVERSE

        if me["aligned"] and me["reverse"]:
            seq = dna.decode(dna.revcomp(me["bases"]))
            qual = "".join(chr(int(q) + phred_offset) for q in me["quals"][::-1])
        else:
            seq = dna.decode(me["bases"])
            qual = "".join(chr(int(q) + phred_offset) for q in me["quals"])

        # placement: an unmapped read sits at its mate's position
        if me["aligned"]:
            rname, local = genome.to_local(me["start"])
            pos = local + 1
        elif mate["aligned"]:
            rname, local = genome.to_local(mate["start"])
            pos = local + 1
        else:
            rname, pos = "*", 0

        if mate["aligned"]:
            mate_rname, mate_local = genome.to_local(mate["start"])
            rnext = "=" if rname == mate_rname else mate_rname
            pnext = mate_local + 1
        elif me["aligned"]:
            rnext, pnext = "=", pos
        else:
            rnext, pnext = "*", 0

        tlen = 0
        if me["aligned"] and mate["aligned"] and tlen_mag:
            if me["start"] < mate["start"] or (me["start"] == mate["start"]
                                               and e == 1):
                tlen = tlen_mag
            else:
                tlen = -tlen_mag

        def end_mapq(end) -> int:
            if not end["aligned"]:
                return 0
            if proper and tscore >= 0:
                # --bam-pessimistic-mapq: min(SM, AS) instead of max
                # (FragmentAccessorBamAdapter.hh:260, manual.md:279)
                pick = min if pessimistic else max
                return min(mapq_cap, pick(end["frag_score"], tscore))
            return min(mapq_cap, end["frag_score"])

        rec = sam.SamRecord(
            qname=name, flag=flag, rname=rname, pos=pos, mapq=end_mapq(me),
            cigar=(me["cigar"] if me["aligned"] else "*"),
            rnext=rnext, pnext=pnext, tlen=tlen, seq=seq, qual=qual,
        )
        if me["aligned"]:
            rec.set_tag("NM", "i", me["nm"])
            rec.set_tag("SM", "i", me["frag_score"])
            if proper and tscore >= 0:
                rec.set_tag("AS", "i", tscore)
        if mate["aligned"]:
            # mate tags: cigar and mapping quality (samtools MC/MQ); MQ
            # equals the MAPQ on the mate's own record
            rec.set_tag("MC", "Z", mate["cigar"])
            rec.set_tag("MQ", "i", end_mapq(mate))
        out.append(rec)
    return out
