"""Output subprocess: record conversion + binning in a separate PROCESS.

The port's own copy of `isaac_aligner_tpu/workflow/output_proc.py`
(single-end and paired-end records), unchanged in behaviour; barcode
resolution (demultiplexing, ROADMAP queue A item 10) is not ported.

The convert/bin stage and the main thread's dispatch/fetch/polish would
otherwise share one interpreter lock.  The reference solves the same
problem with free-threaded C++ (BinningFragmentStorage runs on compute
threads, SelectMatchesTransition.cpp:295-357); the Python equivalent is a
real second process:

    main process: parse -> dispatch -> fetch -> polish
    output process: FragmentBatch conversion -> stats -> bin chunks

The child is spawned (never forked: a fork after CUDA has started is
broken), imports only host modules of the port (storage, records, sam,
fastq, stats_agg; no torch), only ever sees numpy arrays, and returns its
accumulated stats at close().  Payloads move over a bounded
multiprocessing queue; mp pickles on a feeder thread, so even
serialization overlaps the main thread's work.

Enabled by default (ISAAC_TPU_OUTPUT_PROC=0 forces the in-process
OrderedStage path)."""

from __future__ import annotations

import multiprocessing as mp
import os

import numpy as np


def enabled() -> bool:
    if os.environ.get("ISAAC_TPU_OUTPUT_PROC", "1") == "0":
        return False
    # multiprocessing spawn re-imports __main__; a REPL / `python -c` /
    # stdin main has no importable file, so the child would die in runpy
    # — fall back to the in-process OrderedStage path there
    import __main__
    f = getattr(__main__, "__file__", None)
    return bool(f) and os.path.exists(f)


def _child_main(setup: dict, q, rq) -> None:
    """Runs in the spawned child: construct the bin store, convert every
    batch, accumulate stats, reply with the totals."""
    try:
        from ..build import storage as fstore
        from ..build.storage import DistributionBinStore
        from ..io import sam
        from ..io.fastq import LazyNames, ReadBatch
        from . import stats_agg

        offsets = np.asarray(setup["contig_offsets"])
        store = DistributionBinStore(
            setup["bins_dir"], offsets, setup["genome_bp"],
            setup["n_bins"], sample_cap=setup["sample_cap"],
            ram_cache_records=0, pre_sort=setup["pre_sort"],
            uniform=setup["uniform"])

        paired = setup.get("paired", False)

        class G:                      # from_*_result needs only these
            contig_offsets = offsets
            total_length = setup["genome_bp"]

        stats = {"total_reads": 0, "aligned": 0, "perfect": 0,
                 "proper_pairs": 0, "mapq_hist": np.zeros(61, np.int64)}
        per_tile: dict = {}

        while True:
            item = q.get()
            if item is None:
                break
            gidx, n_valid, names_mat, names_len, b1c, b2c, res = item
            nm = LazyNames(names_mat, names_len, n_valid)
            b1 = ReadBatch(nm, *b1c)
            if paired:
                fb = fstore.from_paired_result(
                    G, b1, ReadBatch(nm, *b2c), res,
                    mapq_cap=setup["mapq_cap"],
                    pessimistic=setup["pessimistic"],
                    mapq_threshold=setup["mapq_threshold"])
            else:
                fb = fstore.from_single_result(
                    G, b1, res, mapq_cap=setup["mapq_cap"],
                    mapq_threshold=setup["mapq_threshold"])
            mapped = (fb.flag & sam.FLAG_UNMAPPED) == 0
            stats["total_reads"] += len(fb)
            stats["aligned"] += int(mapped.sum())
            if mapped.any():
                stats["mapq_hist"] += np.bincount(
                    np.minimum(fb.mapq[mapped], 60), minlength=61)
                stats["perfect"] += int((mapped & (fb.nm == 0)).sum())
            stats["proper_pairs"] += int(
                (((fb.flag & sam.FLAG_PROPER_PAIR) != 0)
                 & ((fb.flag & sam.FLAG_READ1) != 0)).sum())
            stats_agg.tile_agg(None, fb, mapped, per_tile, (),
                               synth_tile=("1", f"{gidx:04d}"))
            store.add(fb, seq=gidx)
        store.finalize()
        stats["mapq_hist"] = stats["mapq_hist"].tolist()
        rq.put(("ok", {"stats": stats,
                       "per_tile": {"|".join(map(str, k)): v
                                    for k, v in per_tile.items()},
                       "records": store.records}))
    except Exception as e:           # surface child failures to the parent
        import traceback
        rq.put(("error", f"{e!r}\n{traceback.format_exc()}"))


class OutputProcess:
    """Parent handle: submit(batch payload) / close() -> merged stats."""

    def __init__(self, setup: dict, queue_depth: int = 4):
        ctx = mp.get_context("spawn")
        self._q = ctx.Queue(maxsize=queue_depth)
        self._rq = ctx.Queue()
        self._proc = ctx.Process(target=_child_main,
                                 args=(setup, self._q, self._rq),
                                 daemon=True)
        self._proc.start()

    def submit(self, payload) -> None:
        if not self._proc.is_alive():
            # surface the child's error instead of blocking forever
            self.close()
        self._q.put(payload)

    def close(self) -> dict:
        self._q.put(None)
        status, payload = self._rq.get(timeout=600)
        self._proc.join(timeout=60)
        if status != "ok":
            raise RuntimeError(f"output subprocess failed: {payload}")
        payload["per_tile"] = {tuple(k.split("|")): v
                               for k, v in payload["per_tile"].items()}
        return payload
