"""Single-end host driver: read batches in, SAM records out.

Port of the single-end half of `isaac_aligner_tpu/aligner.py:87-314`.
`Aligner.create(index, read_len, device=...)` uploads the index planes to
the device; each batch then runs the torch pipeline (`align_batch`) on
that device, comes to the host with one `.cpu()` per result field, and
goes through the host polish passes in the JAX driver's order: quality
trim masks, masked tail, contig-end clip, gapped polish (banded SW on the
device), long-indel polish, semialigned clip.

Batches run in order.  The JAX driver's single-buffer result packing and
its fetch worker threads existed for the TPU link's per-fetch latency and
are left behind.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from . import dna
from .align import clippers
from .align.gapped import BWA, GapScoring, polish_gapped
from .align.indel import polish_simple_indels
from .align.pipeline import (AlignConfig, IndexArrays, align_batch,
                             bucket_params_for, default_seed_offsets,
                             genome_has_n_for, mask_tail_device, prepare_index)
from .device import require_device
from .index.build import SeedIndex
from .io import sam
from .io.fastq import ReadBatch
from .ops import sw
from .utils import tracing


def _accumulate_finder_stats(acc: dict, res: dict) -> None:
    """Tally MatchFinder-style seed outcome scalars out of a result dict,
    plus one per-batch tally entry (reference MatchTally)."""
    tally = {key: int(res[key]) for key in
             ("seeds_no_match", "seeds_too_many", "pass2_reads",
              "pass2_dropped") if key in res}
    for key, v in tally.items():
        acc[key] = acc.get(key, 0) + v
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
    arrays: IndexArrays
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
    # per-stage wall seconds (dispatch / fetch / polish / records)
    timings: dict = dataclasses.field(default_factory=dict)
    # (query, window) pairs sent to the banded SW kernel
    sw_pairs: int = 0

    def _t(self, key: str, dt: float) -> None:
        self.timings[key] = self.timings.get(key, 0.0) + dt

    @staticmethod
    def create(index: SeedIndex, read_len: int | None = None,
               cfg: AlignConfig | None = None, *, device="cuda",
               **opts) -> "Aligner":
        """Aligner on `device` ("cuda" by default, "cuda:N" or "cpu";
        "cuda" without a card raises, as do reads longer than the SW
        kernel's `sw.MAX_LEN` on a card)."""
        if (torch.device(device).type == "cuda" and read_len is not None
                and read_len > sw.MAX_LEN):
            raise ValueError(f"read_len {read_len} > {sw.MAX_LEN}, the longest "
                             f"read the CUDA banded SW kernel takes")
        dev = require_device(device)
        if cfg is None:
            offsets = default_seed_offsets(read_len or index.seed_len,
                                           index.seed_len)
            cfg = AlignConfig(seed_len=index.seed_len, seed_offsets=offsets)
        cfg = _with_bucket_log2(cfg, index)
        al = Aligner(index=index, cfg=cfg, device=dev,
                     arrays=prepare_index(index, dev, upload_codes=False),
                     **opts)
        # quality trim + semialigned clip run on the device
        al.cfg = dataclasses.replace(
            cfg, quality_trim_cutoff=al.base_quality_cutoff,
            semialigned_clip=al.clip_semialigned)
        return al

    def _dispatch(self, batch: ReadBatch):
        """Adapter-mask on host, enqueue the device pipeline."""
        t0 = time.perf_counter()
        bases = batch.bases.copy()
        quals = batch.quals.copy()
        trims = clippers.adapter_trim_batch(bases, quals, list(self.adapters))
        bases, quals = _pad_to_seed(bases, quals, self.cfg.seed_len)
        # the device gets the original bases and re-applies the adapter
        # mask from the counts; the masked host copies feed the polish
        ob, oq = _pad_to_seed(batch.bases, batch.quals, self.cfg.seed_len)

        def up(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

        tail = up(trims.astype(np.int32))
        mb, mq = mask_tail_device(up(ob), up(oq), tail)
        out = align_batch(self.arrays, mb, mq, self.cfg, tail)
        self._t("dispatch", time.perf_counter() - t0)
        return out, bases, quals, trims, batch

    def _finish(self, pending) -> dict[str, np.ndarray]:
        """Fetch device results (one .cpu() per field), run host polish."""
        out, bases, quals, trims, batch = pending
        t0 = time.perf_counter()
        res = {k: v.cpu().numpy() for k, v in out.items()}
        t1 = time.perf_counter()
        self._t("fetch", t1 - t0)
        total_trims = clippers.apply_quality_trim_masks(
            bases, quals, trims, res.pop("qtrim"))
        clippers.apply_masked_tail_cigar(res, "", total_trims, batch.read_len)
        clippers.clip_contig_ends(res, "", self.index.genome, batch.read_len)
        self.sw_pairs += polish_gapped(
            self.index, self.cfg, res, bases, self.device, quals=quals,
            gs=self.gap_scoring, trigger=self.gapped_mismatches,
            avoid_sw=self.avoid_smith_waterman)
        polish_simple_indels(self.index, self.cfg, res, bases, quals=quals,
                             gs=self.gap_scoring,
                             trigger=max(6, self.gapped_mismatches + 1),
                             max_gap=self.semialigned_gap_limit)
        if self.clip_semialigned:
            clippers.apply_semialigned_device(res, "", bases.shape[1])
        self._t("polish", time.perf_counter() - t1)
        return res

    def _record_stats(self, batch: ReadBatch, res: dict) -> None:
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
        t0 = time.perf_counter()
        genome = self.index.genome
        records: list[sam.SamRecord] = []
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
                qual = "".join(chr(int(q) + phred_offset) for q in quals[::-1])
            else:
                seq = dna.decode(bases)
                qual = "".join(chr(int(q) + phred_offset) for q in quals)
            if aligned:
                contig, local = genome.to_local(int(res["start"][i]))
                cigars = res.get("cigar")
                cigar = (cigars[i] if cigars and cigars[i] else f"{length}M")
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
        self._t("records", time.perf_counter() - t0)
        return records
