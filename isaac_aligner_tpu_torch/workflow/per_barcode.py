"""Per-barcode reference / adapters / TLS: one run, heterogeneous
samples.

Reference analog: BarcodeMetadata carries a per-barcode reference index
(flowcell/BarcodeMetadata.hh:134-136 — including deliberately
"unmapped" barcodes), per-barcode adapters (:63-66), and AlignWorkflow
keeps a TemplateLengthStatistics per barcode
(workflow/AlignWorkflow.hh:270).

The port's own copy of `isaac_aligner_tpu/workflow/per_barcode.py`: the
same samples, streams and outputs.  The device pipeline is batched and
takes one TLS model a batch, so per-barcode models need per-barcode
batches, not per-row model plumbing.  PerBarcodeDriver partitions the
demultiplexed stream by sample, rebatches each sample's rows into full
fixed-shape batches, and runs one sub-workflow per sample (own reference
index, own adapters, own learned TLS, own out/<sample>/sorted.bam), one
after the other on the same device.  Each sub-workflow's aligner and
index planes are dropped before the next one starts; on a card,
`device_bytes` records `torch.cuda.memory_allocated` after each sample.

The reference single-passes its input because its per-cluster loop can
switch per-read state freely; the per-sample passes here re-parse the
input K times — a deliberate trade for keeping every sample on the
fixed-shape batched pipeline.
"""

from __future__ import annotations

import dataclasses
import gc
import json
from pathlib import Path

import numpy as np

from ..demultiplexing.resolver import resolve_barcodes
from ..demultiplexing.samplesheet import BarcodeSpec, parse_sample_sheet
from ..io.fastq import LazyNames, ReadBatch, pad_batch


def sheet_has_per_barcode_columns(path) -> bool:
    specs = parse_sample_sheet(path)
    return any(sp.reference or sp.adapter for sp in specs)


class _Rebatcher:
    """Accumulate selected rows into full fixed-size ReadBatches."""

    def __init__(self, batch_size: int):
        self.bs = batch_size
        self._parts: list[ReadBatch] = []
        self._rows = 0

    @staticmethod
    def _take(b: ReadBatch, rows: np.ndarray) -> ReadBatch:
        names = b.names
        if isinstance(names, LazyNames):
            nm = LazyNames(names.mat[rows], names.lens[rows])
        else:
            nm = [names[int(r)] for r in rows]
        return ReadBatch(nm, b.bases[rows], b.quals[rows], b.lengths[rows])

    @staticmethod
    def _concat(parts: list[ReadBatch]) -> ReadBatch:
        if len(parts) == 1:
            return parts[0]
        w = max(p.read_len for p in parts)
        widen = []
        from ..io.fastq import _widen
        for p in parts:
            widen.append(_widen(p, w))
        names: list[str] = []
        for p in widen:
            names.extend(list(p.names))
        return ReadBatch(names,
                         np.concatenate([p.bases for p in widen]),
                         np.concatenate([p.quals for p in widen]),
                         np.concatenate([p.lengths for p in widen]))

    def add(self, b: ReadBatch, rows: np.ndarray):
        if rows.size:
            self._parts.append(self._take(b, rows))
            self._rows += rows.size
        while self._rows >= self.bs:
            cat = self._concat(self._parts)
            out = ReadBatch(cat.names[: self.bs], cat.bases[: self.bs],
                            cat.quals[: self.bs], cat.lengths[: self.bs])
            rest_rows = np.arange(self.bs, self._rows)
            self._parts = ([self._take(cat, rest_rows)]
                           if rest_rows.size else [])
            self._rows -= self.bs
            yield out

    def flush(self):
        if self._rows:
            cat = self._concat(self._parts)
            self._parts, self._rows = [], 0
            yield pad_batch(cat, self.bs)


class PerBarcodeDriver:
    """K sub-workflows muxed by barcode (see module docstring)."""

    def __init__(self, opts):
        self.opts = opts
        self.specs = parse_sample_sheet(opts.sample_sheet)
        self.out = Path(opts.output_dir)
        #: sample -> the card's allocated bytes after its sub-workflow (a
        #: card run only)
        self.device_bytes: dict[str, int] = {}

    # -- sample table -------------------------------------------------------

    def _samples(self) -> list[dict]:
        """One entry per distinct sample: specs, reference, adapters."""
        by_name: dict[str, dict] = {}
        for sp in self.specs:
            e = by_name.setdefault(sp.sample, {"specs": [], "sample": sp.sample})
            e["specs"].append(sp)
        out = []
        for name, e in by_name.items():
            refs = {sp.reference for sp in e["specs"]}
            if len(refs) > 1:
                raise ValueError(
                    f"sample {name!r}: conflicting per-barcode references "
                    f"{sorted(refs)}")
            ref = refs.pop()
            e["reference"] = (None if ref.strip().lower() == "unmapped"
                              else (ref or self.opts.reference))
            ads: set[tuple] = {sp.adapters for sp in e["specs"]}
            if len(ads) > 1:
                raise ValueError(
                    f"sample {name!r}: conflicting per-barcode adapters")
            e["adapters"] = ads.pop() or tuple(self.opts.adapters)
            out.append(e)
        return out

    # -- demultiplexed per-sample stream -----------------------------------

    def _sample_stream_factory(self, sample_specs: list[BarcodeSpec]):
        """A re-invocable factory yielding (b1, b2, None) batches holding
        only this sample's reads (full batches, padded tail)."""
        spec_ids = {sp.index for sp in sample_specs}
        no_index = any(sp.is_no_index for sp in sample_specs)
        opts = self.opts

        def factory():
            from .align import AlignWorkflow, WorkflowOptions
            probe = AlignWorkflow(WorkflowOptions(**dataclasses.asdict(opts)))
            paired = probe._paired
            rb1 = _Rebatcher(opts.batch_size)
            rb2 = _Rebatcher(opts.batch_size) if paired else None
            for b1, b2, bc in probe._batch_stream():
                n_valid = b1.n_valid
                if bc is None or no_index:
                    # no index read (or a NoIndex row): all reads belong
                    # to the no-index sample, none to anything else
                    sel = np.full(n_valid, bool(no_index or not spec_ids))
                else:
                    bidx = resolve_barcodes(bc[:n_valid], self.specs,
                                            opts.barcode_mismatches)
                    sel = (np.isin(bidx, list(spec_ids)) if spec_ids
                           else bidx < 0)
                rows = np.nonzero(sel)[0]
                outs1 = list(rb1.add(b1, rows))
                outs2 = list(rb2.add(b2, rows)) if paired else [None] * len(outs1)
                for o1, o2 in zip(outs1, outs2):
                    yield o1, o2, None
            tail1 = list(rb1.flush())
            tail2 = list(rb2.flush()) if paired else [None] * len(tail1)
            for o1, o2 in zip(tail1, tail2):
                yield o1, o2, None

        return factory

    # -- unmapped-barcode output -------------------------------------------

    def _write_unmapped(self, name: str, factory) -> int:
        """Reads of an 'unmapped'-reference barcode skip alignment and
        land in out/<name>/sorted.bam as unmapped records (reference:
        BarcodeMetadata unmapped reference index)."""
        from ..build.records import FragmentBatch
        from ..build.storage import _name_matrix
        from ..io import sam
        from ..io.bam import BamWriter

        d = self.out / name
        d.mkdir(parents=True, exist_ok=True)
        w = BamWriter(d / "sorted.bam", [],
                      compression_level=self.opts.compression_level,
                      write_index=False, sample=name)
        n_out = 0
        for b1, b2, _ in factory():
            ends = [b1] + ([b2] if b2 is not None else [])
            n = b1.n_valid
            for e_i, b in enumerate(ends):
                idx = np.arange(n)
                fb = FragmentBatch.empty(n, b.read_len, max_cigar=1)
                fb.name_bytes, fb.name_len = _name_matrix(b.names, idx)
                flag = sam.FLAG_UNMAPPED
                if b2 is not None:
                    flag |= (sam.FLAG_PAIRED | sam.FLAG_MATE_UNMAPPED
                             | (sam.FLAG_READ1 if e_i == 0 else sam.FLAG_READ2))
                fb.flag = np.full(n, flag, np.uint16)
                fb.ref_id = np.full(n, -1, np.int32)
                fb.pos = np.full(n, -1, np.int32)
                fb.mate_ref_id = np.full(n, -1, np.int32)
                fb.mate_pos = np.full(n, -1, np.int32)
                fb.seq = b.bases[idx]
                fb.qual = b.quals[idx]
                fb.length = b.lengths[idx].astype(np.int32)
                w.write_fragment_batch(fb)
                n_out += n
        w.close()
        return n_out

    def _record_device_bytes(self, name: str) -> None:
        if not str(self.opts.device).startswith("cuda"):
            return
        import torch

        from ..device import require_device
        self.device_bytes[name] = torch.cuda.memory_allocated(
            require_device(self.opts.device))

    # -- driver -------------------------------------------------------------

    def run(self) -> dict:
        from .align import AlignWorkflow, WorkflowOptions

        self.out.mkdir(parents=True, exist_ok=True)
        results: dict = {}
        entries = self._samples()
        from ..demultiplexing.samplesheet import UNKNOWN_SAMPLE
        if (not any(e["sample"].lower() in (UNKNOWN_SAMPLE, "undetermined")
                    for e in entries)
                and not any(sp.is_no_index for sp in self.specs)):
            # unresolved barcodes -> out/unknown against the run's -r
            # reference (reference: the Undetermined sample)
            entries.append({"sample": UNKNOWN_SAMPLE, "specs": [],
                            "reference": self.opts.reference,
                            "adapters": tuple(self.opts.adapters)})
        for entry in entries:
            name = entry["sample"]
            factory = self._sample_stream_factory(entry["specs"])
            if entry["reference"] is None:
                n = self._write_unmapped(name, factory)
                results[name] = {"reads": n, "reference": "unmapped"}
                continue
            sub_opts = dataclasses.asdict(self.opts)
            sub_opts.update(
                reference=entry["reference"],
                output_dir=str(self.out / name),
                adapters=tuple(entry["adapters"]),
                sample=name,
                sample_sheet=None,       # stream is already demultiplexed
                allow_empty_flowcells=True,
            )
            wf = AlignWorkflow(WorkflowOptions(**sub_opts))
            wf._stream_factory = factory
            wf.run()
            results[name] = {
                "reference": entry["reference"],
                "tls": wf._stats.get("tls"),
                "reads": wf._stats.get("match_selector", {}).get("total_reads"),
                "aligned": wf._stats.get("match_selector", {}).get("aligned"),
            }
            # the sample's index and aligner go before the next sample
            # uploads its own
            del wf
            gc.collect()
            self._record_device_bytes(name)
        (self.out / "Stats").mkdir(exist_ok=True)
        (self.out / "Stats" / "PerBarcodeStats.json").write_text(
            json.dumps(results, indent=2, default=str))
        return results
