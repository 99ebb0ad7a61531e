"""Everything the benchmark takes from the program under test
(`isaac_aligner_tpu_torch`, the PyTorch and CUDA port): its input types,
its index build, its workflow and library entries, its counters and its
kernel names.  No other module of the benchmark imports the program, and
the reference imports nothing of it.

Besides the calls a user makes, this module holds the instrumentation of
traced runs (spans around the calls into each layer, and the shapes of
each `banded_sw` launch) and the faults and control that the benchmark's
tests plant underneath a run.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import shutil
from pathlib import Path

import numpy as np

from generator import ACGTN, SimGenome

SW_KERNEL = "banded_sw_kernel"
#: prefix of the benchmark's own spans in a trace
SPAN = "bench:"


def port_root() -> Path:
    import isaac_aligner_tpu_torch
    return Path(isaac_aligner_tpu_torch.__file__).resolve().parent


def port_genome(sim: SimGenome):
    from isaac_aligner_tpu_torch.io.fasta import ContigMeta, Genome
    contigs = []
    for i, (name, off, ln) in enumerate(zip(sim.names, sim.offsets,
                                            sim.lengths)):
        md5 = hashlib.md5(ACGTN[sim.codes[off:off + ln]].tobytes()).hexdigest()
        contigs.append(ContigMeta(index=i, name=name, offset=int(off),
                                  length=int(ln), md5=md5))
    return Genome(codes=sim.codes, contigs=contigs)


def index_key(config: dict, sources: list[Path]) -> str:
    """Digest of what an index depends on: the configuration's genome and
    index blocks, the frozen generator and the program's index sources."""
    h = hashlib.sha256(json.dumps([config["genome"], config["index"]],
                                  sort_keys=True).encode())
    for p in sources:
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def ensure_index(config: dict, genome: SimGenome, cache: Path) -> tuple[Path, float]:
    """The configuration's index directory under `cache`, built by the
    program's own `build_index` (or `build_grouped_indexes` past the
    configuration's group limit) when no build for this key exists.
    Returns (directory, seconds spent building, 0 when loaded)."""
    import time
    root = port_root()
    here = Path(__file__).resolve().parent
    sources = sorted((root / "index").glob("*.py")) + [
        root / "io" / "fasta.py", here / "generator.py"]
    out = cache / f"{config['name']}-{index_key(config, sources)}"
    if (out / "DONE").is_file():
        return out, 0.0
    t0 = time.perf_counter()
    tmp = cache / f"{out.name}.building"
    shutil.rmtree(tmp, ignore_errors=True)
    shutil.rmtree(out, ignore_errors=True)
    from isaac_aligner_tpu_torch.index.build import build_index
    from isaac_aligner_tpu_torch.index.groups import build_grouped_indexes
    g = port_genome(genome)
    ix = config["index"]
    limit = int(ix.get("group_limit", 2**31 - 1))
    if g.total_length > limit:
        build_grouped_indexes(g, tmp, limit=limit, seed_len=ix["seed_len"],
                              device="cpu")
    else:
        build_index(g, seed_len=ix["seed_len"], device="cpu").save(tmp)
    (tmp / "DONE").write_text("")
    tmp.rename(out)
    return out, time.perf_counter() - t0


def load_indexes(path: Path) -> list:
    from isaac_aligner_tpu_torch.index.build import SeedIndex
    from isaac_aligner_tpu_torch.index.groups import (is_grouped_reference,
                                                      load_grouped_indexes)
    if is_grouped_reference(path):
        return load_grouped_indexes(path)
    return [SeedIndex.load(path)]


def read_batch(bases: np.ndarray, quals: np.ndarray, first: int):
    """A parsed batch of the program's type: rows named t<first + i>."""
    from isaac_aligner_tpu_torch.io.fastq import ReadBatch
    n, l = bases.shape
    return ReadBatch(names=[f"t{first + i}" for i in range(n)],
                     bases=np.ascontiguousarray(bases),
                     quals=np.ascontiguousarray(quals),
                     lengths=np.full(n, l, np.int32))


def paired_aligner(indexes: list, read_len: int, device: str, **options):
    """The paired aligner library over one index or contig groups, at its
    defaults but for `options` (PairedAligner fields: the configuration's
    `options`)."""
    from isaac_aligner_tpu_torch.aligner import PairedAligner
    from isaac_aligner_tpu_torch.parallel.multi_index import \
        MultiIndexPairedAligner
    if len(indexes) > 1:
        return MultiIndexPairedAligner.create(indexes, read_len=read_len,
                                              device=device, **options)
    return PairedAligner.create(indexes[0], read_len=read_len, device=device,
                                **options)


def run_workflow(reference: Path, fastq1: Path, fastq2: Path, out: Path,
                 device: str, options: dict) -> dict:
    """One FASTQ pair -> sorted BAM job at the workflow's defaults (and
    the configuration's `options`); returns its Stats files."""
    from isaac_aligner_tpu_torch.workflow.align import (AlignWorkflow,
                                                        WorkflowOptions)
    AlignWorkflow(WorkflowOptions(
        reference=str(reference), output_dir=str(out), fastq1=str(fastq1),
        fastq2=str(fastq2), device=device, **options)).run()
    return {name: json.loads((out / "Stats" / f"{name}.json").read_text())
            for name in ("MatchSelectorStats", "BuildStats")}


# -- traced runs ------------------------------------------------------------

@contextlib.contextmanager
def instrumented(launches: list):
    """Spans (torch.profiler record_function) around the calls into each
    layer, and each banded_sw launch's (pairs, length) appended to
    `launches`, for the length of the block."""
    import torch
    from isaac_aligner_tpu_torch.aligner import PairedAligner
    from isaac_aligner_tpu_torch.ops import sw
    from isaac_aligner_tpu_torch.parallel.multi_index import \
        MultiIndexPairedAligner
    from isaac_aligner_tpu_torch.workflow.align import AlignWorkflow

    patched = []

    def wrap(owner, attr, label):
        orig = getattr(owner, attr)

        def spanned(*a, **k):
            name = label(a) if callable(label) else label
            with torch.profiler.record_function(name):
                return orig(*a, **k)
        patched.append((owner, attr, orig))
        setattr(owner, attr, spanned)

    wrap(PairedAligner, "_dispatch", SPAN + "aligner.dispatch")
    wrap(PairedAligner, "_finish", SPAN + "aligner.fetch_polish")
    wrap(PairedAligner, "learn_tls", SPAN + "aligner.learn_tls")
    wrap(MultiIndexPairedAligner, "_merge", SPAN + "multi_index.merge")
    phase = {"Start": "tls", "TlsDone": "align", "AlignDone": "reports",
             "ReportsDone": "build"}
    wrap(AlignWorkflow, "step",
         lambda a: f"{SPAN}workflow.{phase.get(a[0].state, a[0].state)}")
    orig_sw = sw.banded_sw

    def recorded(query, db, *a, **k):
        if query.device.type == "cuda" and query.numel():
            launches.append(tuple(int(x) for x in query.shape))
        return orig_sw(query, db, *a, **k)
    recorded.launches = orig_sw.launches
    patched.append((sw, "banded_sw", orig_sw))
    sw.banded_sw = recorded
    try:
        yield launches
    finally:
        orig_sw.launches = recorded.launches
        for owner, attr, orig in reversed(patched):
            setattr(owner, attr, orig)


# -- the candidates the reference follows ----------------------------------

CAND_KEYS = ("cand_start", "cand_orient", "cand_valid", "aligned", "start",
             "reverse", "log_prob", "cigar")


@contextlib.contextmanager
def candidates_kept(store: dict, templates: np.ndarray):
    """For the length of the block, each alignment batch's candidate lists,
    and its chosen alignment with its log-probability as the aligner hands
    it on, of the templates in `templates` (sorted ids; rows named t<id>,
    a batch holding consecutive ids) go into `store[(group, first)]`:
    `group` the name of the contig group's first contig, `first` the
    batch's first template, the value (ids, {key + end suffix: rows}).  A
    later batch with the same key replaces the entry."""
    from isaac_aligner_tpu_torch.aligner import PairedAligner
    orig = PairedAligner._finish

    def kept(self, pending):
        res = orig(self, pending)
        b1 = pending[-1][0]
        first = int(b1.names[0][1:])
        lo, hi = np.searchsorted(templates, [first, first + b1.count])
        if lo < hi and int(b1.names[-1][1:]) == first + b1.count - 1:
            ids = templates[lo:hi]
            rows = ids - first
            store[(self.index.genome.contigs[0].name, first)] = (
                ids, {k + e: np.asarray(res.get(k + e) or [None] * b1.count,
                                        dtype=object)[rows]
                      if k == "cigar" else np.asarray(res[k + e])[rows]
                      for k in CAND_KEYS for e in ("_1", "_2")})
        return res

    PairedAligner._finish = kept
    try:
        yield store
    finally:
        PairedAligner._finish = orig


# -- faults planted under a run (the benchmark's tests and control) ---------

def _alter(res: dict) -> dict:
    """An answer altered where it is produced: every aligned read 1 moves
    one base right."""
    res["start_1"] = np.where(res["aligned_1"], res["start_1"] + 1,
                              res["start_1"])
    return res


def _half(res: dict) -> dict:
    """Half of the batch left out: the second half of the rows comes back
    unaligned."""
    n = len(res["aligned_1"])
    for e in ("_1", "_2"):
        a = np.asarray(res["aligned" + e]).copy()
        a[n // 2:] = False
        res["aligned" + e] = a
    return res


class _Stale:
    """A step that returns its state unchanged: each batch gets the
    previous batch's results."""

    def __init__(self):
        self.last = None

    def __call__(self, res: dict) -> dict:
        prev, self.last = self.last, res
        return res if prev is None else prev


@contextlib.contextmanager
def planted(name: str | None):
    """Run the block with fault `name` planted in the program (None: as
    it is).  `bf16_log_probs`, the control, rounds the per-base match and
    mismatch log-probabilities the card sums to bfloat16, the precision
    below the configurations' float32.  The faults break the timed path
    underneath: `altered`, `half_left_out` and `stale` the results of each
    batch; `dedup_off` Build's duplicate marking; `gapped_polish_off` the
    banded-SW polish; `second_pass_off` the seed offsets of the second
    pass (`second_pass_fraction` 0, a sub-batch of one read);
    `merge_left_out` every contig group but the first, in the merge."""
    if name is None:
        yield
        return
    from isaac_aligner_tpu_torch.aligner import PairedAligner
    from isaac_aligner_tpu_torch.build import dedup
    from isaac_aligner_tpu_torch.parallel.multi_index import \
        MultiIndexPairedAligner
    patched = []

    def patch(owner, attr, new):
        patched.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, new)

    def on_results(fn):
        orig = PairedAligner.align_batch_arrays
        orig_m = MultiIndexPairedAligner.align_batch_arrays
        patch(PairedAligner, "align_batch_arrays",
              lambda self, b1, b2: fn(orig(self, b1, b2)))
        patch(MultiIndexPairedAligner, "align_batch_arrays",
              lambda self, b1, b2: fn(orig_m(self, b1, b2)))

    if name == "altered":
        on_results(_alter)
    elif name == "half_left_out":
        on_results(_half)
    elif name == "stale":
        on_results(_Stale())
    elif name == "merge_left_out":
        orig = MultiIndexPairedAligner._merge
        patch(MultiIndexPairedAligner, "_merge",
              lambda self, b1, b2, results: orig(self, b1, b2, results[:1]))
    elif name == "gapped_polish_off":
        from isaac_aligner_tpu_torch import aligner
        patch(aligner, "polish_gapped", lambda *a, **k: 0)
    elif name == "dedup_off":
        patch(dedup, "mark_duplicates_batch",
              lambda fb, *a, **k: fb)
    elif name == "bf16_log_probs":
        from isaac_aligner_tpu_torch.align import quality
        import torch
        orig_tables = quality.log_tables

        def bf16_tables(device):
            return tuple(t.to(torch.bfloat16).to(torch.float32)
                         for t in orig_tables(device))
        patch(quality, "log_tables", bf16_tables)
    elif name == "second_pass_off":
        orig = PairedAligner.create

        def one_pass(*a, **k):
            al = orig(*a, **k)
            al.cfg = dataclasses.replace(al.cfg, second_pass_fraction=0.0)
            return al
        patch(PairedAligner, "create", staticmethod(one_pass))
    else:
        raise KeyError(f"no fault {name!r}")
    try:
        yield
    finally:
        for owner, attr, orig in reversed(patched):
            setattr(owner, attr, orig)

