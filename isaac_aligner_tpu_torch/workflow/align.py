"""The checkpointed alignment workflow, FASTQ to sorted BAM.

Port of the single-device, FASTQ-input paths (single-end and paired-end)
of `isaac_aligner_tpu/workflow/align.py` (reference workflow::AlignWorkflow,
src/c++/include/workflow/AlignWorkflow.hh:64-292): a phase state machine
whose state serializes to Temp/AlignerState.json after every completed
phase, with --start-from / --stop-at rewind semantics.  `STATES` and the
on-disk layout of Temp/ (AlignerState.json, bins/bin_*/chunk_*.cols,
bins/boundaries.json) are the JAX package's, so a run can be resumed, and
the BAM, its .bai and its .md5 are byte-equal to the JAX workflow's on the
same inputs.

    Start -> TlsDone      pairs: template-length statistics learned from
                          the first batches (or --tls), saved with the state
          -> AlignDone    align all batches on `device`; columnar records
                          stream to genomic bins (output process)
          -> ReportsDone  stats JSON/XML + HTML report
          -> BamDone      per bin: coordinate sort, duplicate marking,
                          known-gap realignment; BGZF BAM + .bai + .md5

Options of the JAX workflow that select a path this slice does not run
raise NotImplementedError naming their ROADMAP item (`check_ported`); none
of them quietly takes another path.  The aligner runs on `device` ("cuda" by
default; "cuda" without a card raises before any work).
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import numpy as np

from ..align.pairs import TlsStatic
from ..align.pipeline import AlignConfig, default_seed_offsets
from ..aligner import Aligner, PairedAligner
from ..build.storage import DistributionBinStore
from ..device import require_device
from ..index.build import SeedIndex, build_index
from ..io import sam
from ..io.fasta import read_fasta

STATES = ("Start", "TlsDone", "AlignDone", "ReportsDone", "BamDone")


def parse_tls_override(spec: str) -> TlsStatic:
    """--tls 'min:median:max:lowStdDev:highStdDev:M0:M1' (manual.md:572-575)
    -> the static TLS model (mate window = [min, max], reference
    --mate-drift-range -1 default)."""
    parts = spec.split(":")
    if len(parts) != 7:
        raise ValueError(
            f"--tls {spec!r}: want min:median:max:lowStdDev:highStdDev:M0:M1")
    mn, median, mx, _lo_sd, _hi_sd, m0, m1 = (int(x) for x in parts)
    if not (0 <= m0 <= 7 and 0 <= m1 <= 7):
        raise ValueError(f"--tls {spec!r}: models must be 0..7 (FFp..RRm)")
    return TlsStatic(min=mn, max=mx, mate_min=mn, mate_max=mx,
                     best0=m0, best1=m1, median=median)


@dataclasses.dataclass
class WorkflowOptions:
    """The JAX workflow's options, field for field, plus `device`.

    The FASTQ paths (single-end and paired-end) honour every option that
    acts on them.  The options of inputs and modes the port does not run
    are kept so that both packages take the same keywords: the ones that
    select such a path raise (`check_ported`), the ones that only tune one
    have no effect here, as in the JAX workflow's FASTQ runs."""

    reference: str                      # FASTA path or saved index directory
    output_dir: str
    fastq1: str | None = None
    fastq2: str | None = None           # paired-end when set
    bam_input: str | None = None        # BAM input: not ported
    run_folder: str | None = None       # BCL run folder: not ported
    lanes: tuple[int, ...] | None = None    # lane subset of a FASTQ lane dir
    tiles: tuple[int, ...] | None = None    # BCL only
    pf_only: bool = True                # BCL only
    use_bases_mask: str | None = None   # BCL only
    ignore_missing_bcls: bool = False   # BCL only
    ignore_missing_filters: bool = False    # BCL only
    seed_len: int = 32
    group_limit: int = 2**31 - 1
    batch_size: int = 4096
    # reference --neighborhood-size-threshold (0 = off)
    neighborhood_size_threshold: int = 0
    tls_batches: int = 4                # paired: batches TLS learns from
    keep_duplicates: bool = True        # mark, don't remove (reference default)
    mark_duplicates: bool = True
    gapped: bool = True                 # read by neither package
    sample: str = "sample"
    compression_level: int = 1
    base_quality_cutoff: int = 25
    clip_semialigned: bool = True
    clip_overlapping: bool = True       # paired only
    adapters: tuple[str, ...] = ()
    sample_sheet: str | None = None     # demultiplexing: not ported
    barcode_fastq: str | None = None    # demultiplexing only
    barcode_mismatches: int = 1         # demultiplexing only
    # known-gap realignment in the Build phase: no | sample | project | all
    realign_gaps: str = "sample"
    gap_scoring: str = "bwa"
    seeds: str = "auto"
    repeat_threshold: int = 10
    first_pass_seeds: int = 1
    dodgy_alignment_score: str = "0"
    tls_override: str | None = None     # paired only
    mate_drift_range: int = -1          # paired only
    pessimistic_mapq: bool = False      # paired only
    records_per_bin: int = 1_000_000
    bam_exclude_tags: str = "ZX,ZY"
    memory_limit: float = 0.0
    devices: int = 0                    # SPMD: not ported beyond 0/1
    shard_genome: bool = False          # SPMD only
    keep_unaligned: str = "back"
    mapq_threshold: int = 0
    gapped_mismatches: int = 5
    semialigned_gap_limit: int = 100
    shadow_scan_range: int = -1         # paired only
    realigned_gaps_per_fragment: int = 4
    single_library_samples: bool = True     # BCL only (lanes from names)
    qscore_bin: bool = False
    qscore_bin_values: str = ("0:0,1:1,2-9:6,10-19:15,20-24:22,25-29:27,"
                              "30-34:33,35-39:37,40-63:40")
    variable_read_length: bool = False
    bin_regex: str = "all"
    bam_header_tags: tuple[str, ...] = ()
    input_parallel_load: int = 2
    output_parallel_save: int = 2
    per_tile_tls: bool = False          # BCL paired-end only (no effect on FASTQ)
    ignore_neighbors: bool = False
    ignore_repeats: bool = False
    scatter_repeats: bool = False
    avoid_smith_waterman: bool = False
    realign_dodgy: bool = False
    realign_vigorously: bool = False
    cleanup_intermediary: bool = False
    memory_control: str = "off"
    allow_empty_flowcells: bool = False
    lane_number_max: int = 8
    bam_pu_format: str = "%F:%L:%B"
    reference_name: str = "default"
    description: str = ""
    stats_image_format: str = "svg"
    expected_bgzf_ratio: float = 1.0
    buffer_bins: bool = True
    pre_sort_bins: bool = True
    base_calls_format: str | None = None
    clusters_at_a_time: int = 0
    tiles_regex: str | None = None      # BCL only
    dist_coordinator: str | None = None     # multi-host only
    dist_processes: int = 0             # multi-host: not ported beyond 0/1
    dist_process_id: int = -1
    uniform_bins: bool = False
    # the aligner's device: "cuda" (default; raises without a card),
    # "cuda:N" or "cpu"
    device: str = "cuda"

    def qscore_table(self) -> "np.ndarray | None":
        """64-entry quality remap table from --qscore-bin-values."""
        if not self.qscore_bin:
            return None
        t = np.arange(64, dtype=np.uint8)
        for part in self.qscore_bin_values.split(","):
            rng, _, val = part.strip().partition(":")
            if not val:
                raise ValueError(f"--qscore-bin-values: bad entry {part!r}")
            a, _, b = rng.partition("-")
            lo_, hi_ = int(a), int(b or a)
            t[lo_ : hi_ + 1] = int(val)
        return t

    def excluded_tags(self) -> frozenset[str]:
        spec = (self.bam_exclude_tags or "none").strip()
        allowed = {"AS", "BC", "NM", "OC", "RG", "SM", "ZX", "ZY"}
        if spec.lower() == "all":
            return frozenset(allowed)
        if spec.lower() == "none":
            return frozenset()
        tags = {t.strip().upper() for t in spec.split(",") if t.strip()}
        bad = tags - allowed
        if bad:
            raise ValueError(
                f"--bam-exclude-tags: unknown tag(s) {sorted(bad)}; "
                f"allowed: all,none,{','.join(sorted(allowed))}")
        return frozenset(tags)


#: (option, what it asks for, ROADMAP queue A item) for every option that
#: selects a path the port does not run; the options that act only on
#: those paths (the BCL and barcode ones) have no effect on a FASTQ run in
#: the JAX workflow either
_NOT_PORTED = (
    ("run_folder", "BCL run-folder input", 8),
    ("bam_input", "BAM input", 9),
    ("sample_sheet", "demultiplexing (sample sheets, per-barcode runs)", 10),
)


def check_ported(opts: WorkflowOptions) -> None:
    """Raise NotImplementedError for an option whose path is not ported."""
    def refuse(what: str, item: int) -> None:
        raise NotImplementedError(
            f"{what} is not ported to isaac_aligner_tpu_torch yet (ROADMAP "
            f"queue A item {item})")

    for name, what, item in _NOT_PORTED:
        if getattr(opts, name):
            refuse(what, item)
    if opts.devices not in (0, 1):
        refuse(f"--devices {opts.devices} (SPMD)", 7)
    if opts.dist_processes > 1:
        refuse("multi-host runs", 7)
    ref = Path(str(opts.reference))
    if "," in str(opts.reference) or (ref / "multi-reference.json").exists():
        refuse("contig-group (multi-index) references", 5)


class AlignWorkflow:
    def __init__(self, opts: WorkflowOptions):
        check_ported(opts)
        self.opts = opts
        self.out = Path(opts.output_dir)
        self.temp = self.out / "Temp"
        self.stats_dir = self.out / "Stats"
        for d in (self.out, self.temp, self.stats_dir):
            d.mkdir(parents=True, exist_ok=True)
        self.state = "Start"
        self.tls: TlsStatic | None = None
        self._index: SeedIndex | None = None
        self._stats: dict = {}
        self._bin_cache = None

    # -- state (de)serialization -------------------------------------------

    @property
    def state_file(self) -> Path:
        return self.temp / "AlignerState.json"

    def save_state(self) -> None:
        doc = {"state": self.state, "stats": self._stats}
        if self.tls is not None:
            doc["tls"] = dataclasses.asdict(self.tls)
        self.state_file.write_text(json.dumps(doc, indent=2))

    def load_state(self) -> None:
        if self.state_file.exists():
            doc = json.loads(self.state_file.read_text())
            self.state = doc["state"]
            self._stats = doc.get("stats", {})
            if "tls" in doc:
                self.tls = TlsStatic(**doc["tls"])

    def rewind(self, start_from: str) -> None:
        """Reference AlignWorkflow::rewind — drop back to an earlier state."""
        if start_from not in STATES:
            raise ValueError(f"unknown state {start_from}")
        if STATES.index(start_from) < STATES.index(self.state):
            self.state = start_from

    # -- shared resources ---------------------------------------------------

    def _apply_mate_drift(self) -> None:
        """--mate-drift-range: rescue window = median +- range
        (reference TemplateLengthStatistics setMin/setMax)."""
        d = self.opts.mate_drift_range
        if d >= 0 and self.tls is not None:
            self.tls = dataclasses.replace(
                self.tls, mate_min=self.tls.median - d,
                mate_max=self.tls.median + d)

    def _load_index(self) -> SeedIndex:
        """The saved index directory, or an index built from the FASTA."""
        if self._index is None:
            ref = Path(self.opts.reference)
            if ref.is_dir():
                self._index = SeedIndex.load(ref)
            else:
                genome = read_fasta(ref)
                if genome.total_length > self.opts.group_limit:
                    raise NotImplementedError(
                        "contig-group (multi-index) references are not "
                        "ported to isaac_aligner_tpu_torch yet (ROADMAP "
                        "queue A item 5)")
                # 64-mer seeds search a 32-mer index + extension verify
                self._index = build_index(
                    genome, seed_len=min(self.opts.seed_len, 32))
        return self._index

    def _genome(self):
        return self._load_index().genome

    @property
    def _paired(self) -> bool:
        if self.opts.fastq1 and Path(self.opts.fastq1).is_dir():
            files = self._fastq_lane_files()
            return bool(files) and files[0][1] is not None
        return bool(self.opts.fastq2)

    # -- phases -------------------------------------------------------------

    def _phase_tls(self) -> None:
        """Template-length statistics of a paired run: --tls, or learned
        from the first `tls_batches` batches of the input stream (the raw
        batches, before any masking); a single-end run has none."""
        import itertools
        if not self._paired:
            self.tls = None
            return
        if self.opts.tls_override:
            self.tls = parse_tls_override(self.opts.tls_override)
            self._apply_mate_drift()
            self._stats["tls"] = dataclasses.asdict(self.tls)
            return
        learn = [(b1, b2) for b1, b2, _ in
                 itertools.islice(self._batch_stream(),
                                  self.opts.tls_batches)]
        if not learn:
            # empty input: the align phase handles it; default model
            self.tls = None
            return
        # learning runs score_end only: the clip and polish options of the
        # align phase do not enter it
        index = self._load_index()
        read_len = learn[0][0].read_len
        aligner = PairedAligner.create(
            index, read_len=read_len, cfg=self._align_config(read_len, index),
            device=self.opts.device)
        self.tls = aligner.learn_tls(learn)
        self._apply_mate_drift()
        self._stats["tls"] = dataclasses.asdict(self.tls)

    def _align_config(self, read_len: int, index: SeedIndex) -> AlignConfig:
        o = self.opts
        seed_len = max(o.seed_len, index.seed_len)
        if seed_len > 32 and index.seed_len not in (32, 64):
            raise ValueError(
                "64-mer seeds need a 32-mer index (extension-verify mode) "
                "or a true 64-mer LongKmerType index")
        if o.seeds == "auto":
            offsets = default_seed_offsets(read_len, seed_len)
        else:
            first = o.seeds.split(",")[0]
            offsets = tuple(int(x) for x in first.split(":"))
        dodgy = o.dodgy_alignment_score
        return AlignConfig(
            seed_len=seed_len,
            seed_offsets=offsets,
            repeat_threshold=o.repeat_threshold,
            max_hits_per_seed=o.repeat_threshold,
            first_pass_seeds=o.first_pass_seeds,
            dodgy_mapq=0 if dodgy == "Unaligned" else int(dodgy),
            dodgy_unaligned=dodgy == "Unaligned",
            neighborhood_size_threshold=o.neighborhood_size_threshold,
            ignore_neighbors=o.ignore_neighbors,
            ignore_repeats=o.ignore_repeats,
            scatter_repeats=o.scatter_repeats)

    def _phase_align(self) -> None:
        """Align all batches and stream columnar records to genomic bins.

        Three host stages overlap (the reference's load/compute/flush
        thread slots, SelectMatchesTransition.cpp:295-357): input parsing
        runs ahead on a prefetch thread, the main thread drives dispatch,
        fetch and polish on the device in batch order, and record
        conversion + bin writes run in the output process (or, with
        ISAAC_TPU_OUTPUT_PROC=0, on an ordered background thread)."""
        import itertools
        import shutil
        from collections import deque

        from ..align.gapped import GapScoring
        from ..build import storage as fstore
        from ..io.fastq import LazyNames
        from ..utils.pipeline import OrderedStage, prefetch_iter
        from . import output_proc as op
        from .stats_agg import tile_agg

        index = self._load_index()
        t0 = time.time()
        o = self.opts
        stream = self._batch_stream()
        first = next(stream, None)
        if first is None:
            if not o.allow_empty_flowcells:
                raise ValueError(
                    "input contains no reads "
                    "(--allow-empty-flowcells accepts this)")
            # --allow-empty-flowcells (manual.md:271): finish the phase
            # with zero records; the Build phase emits a valid empty BAM
            store = DistributionBinStore(
                self.temp / "bins", self._genome().contig_offsets,
                self._genome().total_length, 1, sample_cap=1)
            store.finalize()
            self._bin_cache = store
            self._stats["match_selector"] = {
                "total_reads": 0, "aligned": 0, "perfect": 0,
                "proper_pairs": 0, "mapq_hist": [0] * 61,
                "align_seconds": 0.0}
            return
        stream = itertools.chain([first], stream)
        read_len = first[0].read_len
        genome = self._genome()
        paired = self._paired
        ends = 2 if paired else 1
        common = dict(read_len=read_len,
                      cfg=self._align_config(read_len, index),
                      device=o.device,
                      base_quality_cutoff=o.base_quality_cutoff,
                      clip_semialigned=o.clip_semialigned,
                      adapters=tuple(o.adapters),
                      gap_scoring=GapScoring.parse(o.gap_scoring),
                      gapped_mismatches=o.gapped_mismatches,
                      semialigned_gap_limit=o.semialigned_gap_limit,
                      avoid_smith_waterman=o.avoid_smith_waterman)
        if paired:
            aligner = PairedAligner.create(
                index, clip_overlapping=o.clip_overlapping,
                pessimistic_mapq=o.pessimistic_mapq,
                shadow_scan_range=o.shadow_scan_range, **common)
            if self.tls is not None:
                aligner.tls = self.tls
        else:
            aligner = Aligner.create(index, **common)

        records_per_bin = self._records_per_bin(read_len)
        self._stats["records_per_bin"] = records_per_bin
        n_bins = max(1, -(-self._estimate_total_reads() * ends
                          // records_per_bin))
        bins_dir = self.temp / "bins"
        if bins_dir.exists():
            shutil.rmtree(bins_dir)
        store = DistributionBinStore(
            bins_dir, genome.contig_offsets, genome.total_length, n_bins,
            sample_cap=max(records_per_bin, 4 * o.batch_size * ends),
            ram_cache_records=records_per_bin if o.buffer_bins else 0,
            pre_sort=o.pre_sort_bins, uniform=o.uniform_bins)
        # the Build phase reuses the RAM chunk cache when it runs in this
        # process (resume-from-disk falls back to the files)
        self._bin_cache = store

        stats = {"total_reads": 0, "aligned": 0, "perfect": 0,
                 "proper_pairs": 0, "mapq_hist": np.zeros(61, np.int64)}
        per_tile: dict[tuple[str, str], dict] = {}
        # the name sidecar rides a queue so the aligner's input stays a
        # plain batch iterator
        sidecar: deque = deque()
        t_host = {"parse": 0.0, "convert": 0.0}

        def feed():
            it = iter(stream)
            gidx = -1
            while True:
                t1 = time.perf_counter()
                nxt = next(it, None)
                t_host["parse"] += time.perf_counter() - t1
                gidx += 1
                if nxt is None:
                    return
                b1, b2, _bc = nxt
                # names stay columnar/lazy; conversion needs the count
                sidecar.append((b1.names, b1.n_valid, gidx))
                yield (b1, b2) if paired else b1

        def convert_emit(inputs, res):
            t1 = time.perf_counter()
            _names, _n_valid, gidx = sidecar.popleft()
            if paired:
                fb = fstore.from_paired_result(
                    genome, inputs[0], inputs[1], res,
                    mapq_cap=aligner.cfg.mapq_cap,
                    pessimistic=o.pessimistic_mapq,
                    mapq_threshold=o.mapq_threshold)
            else:
                fb = fstore.from_single_result(
                    genome, inputs, res, mapq_cap=aligner.cfg.mapq_cap,
                    mapq_threshold=o.mapq_threshold)
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
            # FASTQ inputs: one synthesized tile per batch, as the
            # reference's FastqDataSource.hh:41-118 does
            tile_agg(None, fb, mapped, per_tile, (),
                     synth_tile=("1", f"{gidx:04d}"))
            store.add(fb, seq=gidx)
            t_host["convert"] += time.perf_counter() - t1

        batches = prefetch_iter(feed(), depth=max(1, o.input_parallel_load))
        if op.enabled():
            proc = op.OutputProcess(dict(
                bins_dir=str(bins_dir),
                contig_offsets=np.asarray(genome.contig_offsets),
                genome_bp=genome.total_length, n_bins=n_bins,
                sample_cap=store.sample_cap, pre_sort=o.pre_sort_bins,
                uniform=bool(o.uniform_bins),
                mapq_cap=aligner.cfg.mapq_cap, paired=paired,
                pessimistic=o.pessimistic_mapq,
                mapq_threshold=o.mapq_threshold))

            def submit_proc(inputs, res):
                t1 = time.perf_counter()
                names, n_valid, gidx = sidecar.popleft()
                if not isinstance(names, LazyNames):
                    names = LazyNames.from_list(list(names))
                b1 = inputs[0] if paired else inputs
                b2 = inputs[1] if paired else None
                res2 = {k: v for k, v in res.items()
                        if not k.startswith("cand_")}
                proc.submit((gidx, n_valid, names.mat, names.lens,
                             (b1.bases, b1.quals, b1.lengths),
                             (b2.bases, b2.quals, b2.lengths)
                             if b2 is not None else None, res2))
                t_host["convert"] += time.perf_counter() - t1

            try:
                for inputs, res in aligner.align_results_many(batches):
                    submit_proc(inputs, res)
            finally:
                out = proc.close()
            for k in ("total_reads", "aligned", "perfect", "proper_pairs"):
                stats[k] += out["stats"][k]
            stats["mapq_hist"] += np.asarray(out["stats"]["mapq_hist"],
                                             np.int64)
            for k, v in out["per_tile"].items():
                key = (k[0], k[1], k[2], int(k[3]))
                agg = per_tile.setdefault(key, dict.fromkeys(v, 0))
                for ck, cv in v.items():
                    agg[ck] += cv
            # the child owned the bin store; Build re-reads chunk files
            self._bin_cache = None
        else:
            writer = OrderedStage(convert_emit,
                                  window=max(1, o.output_parallel_save),
                                  name="isaac-convert")
            try:
                for inputs, res in aligner.align_results_many(batches):
                    writer.submit(inputs, res)
            finally:
                writer.close()
            store.finalize()

        if per_tile:
            stats["tiles"] = [
                {"lane": lane, "tile": tile, "barcode": sample,
                 "read": read, **agg}
                for (lane, tile, sample, read), agg in sorted(per_tile.items())]
        stats["align_seconds"] = round(time.time() - t0, 2)
        t_host.update(aligner.timings)
        stats["stage_seconds"] = {k: round(v, 2) for k, v in t_host.items()}
        # device work of the host-driven passes: pairs sent to the banded
        # SW kernel, and (pairs) orphan rows scanned by the rescue
        stats["device_work"] = {k: getattr(aligner, k) for k in
                                ("sw_pairs", "rescue_rows", "rescue_calls")
                                if hasattr(aligner, k)}
        stats["mapq_hist"] = [int(x) for x in stats["mapq_hist"]]
        for k in ("total_reads", "aligned", "perfect", "proper_pairs"):
            stats[k] = int(stats[k])
        self._stats["match_selector"] = stats
        if aligner.finder_stats:
            self._stats["match_finder"] = dict(aligner.finder_stats)

    def _pu_field(self, sample_name: str) -> str:
        """--bam-pu-format (manual.md:281): expand %F (flowcell id; FASTQ
        inputs have none), %L (lane list) and %B (barcode/sample) into the
        @RG PU field."""
        o = self.opts
        lanes = ",".join(str(x) for x in o.lanes) if o.lanes else "all"
        return (o.bam_pu_format.replace("%F", "unknown").replace("%L", lanes)
                .replace("%B", sample_name))

    def _check_base_calls_format(self) -> None:
        """--base-calls-format (manual.md:298): validate the declared
        input format against the provided inputs instead of trusting
        auto-detection."""
        o = self.opts
        fmt = o.base_calls_format
        if not fmt:
            return
        from ..utils.errors import InvalidOptionError
        allowed = ("fastq", "fastq-gz", "bam", "bcl", "bcl-gz", "bcl-bgzf")
        if fmt not in allowed:
            raise InvalidOptionError(
                f"--base-calls-format {fmt!r}: expected one of {allowed}")
        if fmt in ("bcl", "bcl-gz", "bcl-bgzf"):
            raise InvalidOptionError(
                f"--base-calls-format {fmt}: needs --run-folder input")
        if fmt == "bam":
            raise InvalidOptionError(
                "--base-calls-format bam: needs --bam input")
        if not o.fastq1:
            raise InvalidOptionError(
                f"--base-calls-format {fmt}: needs --fastq1 input")
        if not Path(o.fastq1).is_dir():
            with open(o.fastq1, "rb") as f:
                is_gz = f.read(2) == b"\x1f\x8b"
            if is_gz != (fmt == "fastq-gz"):
                raise InvalidOptionError(
                    f"--base-calls-format {fmt}: {o.fastq1} is "
                    f"{'gzipped' if is_gz else 'plain'} FASTQ")

    def _fastq_lane_files(self) -> "list[tuple[str, str | None]]":
        """--fastq1 as a base-calls DIRECTORY: discover
        lane<N>_read<R>.fastq[.gz] pairs for lanes 1..--lane-number-max
        (reference FastqLayout.cpp:45-66 naming + --lane-number-max,
        manual.md:419).  A plain file path returns (fastq1, fastq2)."""
        o = self.opts
        if not o.fastq1:
            raise ValueError("need --fastq1 (the only input the port reads)")
        p = Path(o.fastq1)
        if not p.is_dir():
            return [(o.fastq1, o.fastq2)]
        out: list[tuple[str, str | None]] = []
        want = list(o.lanes) if o.lanes else range(1, o.lane_number_max + 1)
        for lane in want:
            for ext in (".fastq", ".fastq.gz"):
                r1 = p / f"lane{lane}_read1{ext}"
                if r1.exists():
                    r2 = p / f"lane{lane}_read2{ext}"
                    out.append((str(r1), str(r2) if r2.exists() else None))
                    break
        if not out and not o.allow_empty_flowcells:
            raise ValueError(
                f"{p}: no lane<N>_read1.fastq[.gz] files for lanes "
                f"1..{o.lane_number_max} (--allow-empty-flowcells accepts)")
        return out

    def _estimate_total_reads(self) -> int:
        """File-size read-count estimate of the streamed read-1 FASTQ
        (only bin granularity depends on it)."""
        from ..io.fastq import estimate_fastq_reads
        return sum(estimate_fastq_reads(r1)
                   for r1, _ in self._fastq_lane_files())

    def _batch_stream(self):
        """Yield (b1, b2 | None, None) padded batches with input-side
        postprocessing on both ends: --qscore-bin quality remapping and
        the --variable-fastq-read-length uniformity check.  FASTQ streams
        record block by record block (bounded RAM)."""
        from ..io.fastq import iter_fastq_batches
        o = self.opts
        qtab = o.qscore_table()
        for r1, r2 in self._fastq_lane_files():
            for b1, b2, bc in iter_fastq_batches(r1, r2, o.batch_size):
                for b in (b1, b2):
                    if b is None:
                        continue
                    if not o.variable_read_length:
                        ln = b.lengths[: b.n_valid]
                        if ln.size and int(ln.min()) != int(ln.max()):
                            raise ValueError(
                                f"variable read lengths ({int(ln.min())}.."
                                f"{int(ln.max())}) in the input; pass "
                                f"--variable-fastq-read-length to accept "
                                f"(shorter reads pad with N)")
                    if qtab is not None:
                        np.minimum(b.quals, 63, out=b.quals)
                        b.quals[:] = qtab[b.quals]
                yield b1, b2, bc

    def _records_per_bin(self, read_len: int) -> int:
        """Bin size in records, capped by --memory-limit.  Per-record
        footprint through the Build phase: seq+qual bytes, name, packed
        cigars ×2 (own + mate), ~30 int columns, plus sort/dedup scratch
        of the same order -> budget a quarter of the limit for one
        resident bin."""
        o = self.opts
        records_per_bin = o.records_per_bin
        if o.memory_limit:
            rec_bytes = 2 * read_len + 64 + 8 * 16 * 2 + 128
            # --expected-bgzf-ratio (manual.md:373): the serialized-BAM
            # output buffer scales with the assumed compression ratio;
            # only the delta vs the default 1.0 adjusts the estimate
            rec_bytes += int((o.expected_bgzf_ratio - 1.0)
                             * (2 * read_len + 128))
            rec_bytes = max(rec_bytes, 64)
            fit = int(o.memory_limit * 1e9 * 0.25 / rec_bytes)
            if fit < records_per_bin:
                records_per_bin = max(fit, 10_000)
                from ..utils import tracing
                tracing.log(f"--memory-limit {o.memory_limit}G: "
                            f"records_per_bin -> {records_per_bin}")
        return records_per_bin

    def _phase_reports(self) -> None:
        """MatchSelectorStats / AlignmentReportGenerator analog: JSON +
        reference-shaped XML + a self-contained HTML report with inline
        SVG plots (workflow/reports.py)."""
        from . import reports
        stats = self._stats.get("match_selector", {})
        (self.stats_dir / "MatchSelectorStats.json").write_text(
            json.dumps(stats, indent=2))
        reports.write_match_selector_stats_xml(
            stats, self.stats_dir / "MatchSelectorStats.xml",
            sample=self.opts.sample)
        if "match_finder" in self._stats:
            reports.write_match_finder_stats_xml(
                self._stats["match_finder"],
                self.stats_dir / "MatchFinderStats.xml")
        reports.write_html_report(self._stats,
                                  self.stats_dir / "AlignmentReport.html",
                                  image_format=self.opts.stats_image_format)

    def _bin_regex_filter(self, genome):
        """--bin-regex: None (all) or a predicate over aligned-bin dirs.

        Each aligned bin is described as "contig:first-last" (the contig
        holding the bin's start); "unaligned" excludes every aligned bin
        (manual.md:317-323)."""
        import re

        spec = self.opts.bin_regex
        if spec in ("all", "", None):
            return None
        if spec == "unaligned":
            return lambda d: False
        bdoc_path = self.temp / "bins" / "boundaries.json"
        bin_bp = None
        boundaries = None
        if bdoc_path.exists():
            doc = json.loads(bdoc_path.read_text())
            bin_bp = doc["bin_bp"]
            if "boundaries" in doc:
                boundaries = np.asarray(doc["boundaries"], np.int64)
        rx = re.compile(spec)
        offs = genome.contig_offsets
        names = [c.name for c in genome.contigs]

        def describe(d) -> str:
            i = int(d.name.split("_")[1])
            if boundaries is not None:
                lo = int(boundaries[i])
                hi = int(boundaries[i + 1]) if i + 1 < len(boundaries) \
                    else genome.total_length
            elif bin_bp:
                lo, hi = i * bin_bp, (i + 1) * bin_bp
            else:
                lo, hi = 0, genome.total_length
            ci = int(np.searchsorted(offs, lo, side="right") - 1)
            ci = min(max(ci, 0), len(names) - 1)
            return f"{names[ci]}:{lo - offs[ci]}-{hi - offs[ci]}"

        return lambda d: bool(rx.search(describe(d)))

    def _process_bin_fb(self, fb, genome):
        """Sort + dedup + realign one bin, columnar (BinSorter::process).
        Without a sample sheet the whole bin is one library and one
        gap-sharing scope."""
        from ..build.dedup import coordinate_sort_order, mark_duplicates_batch
        from ..build.realign import realign_batch

        o = self.opts
        fb = fb.take(coordinate_sort_order(fb))
        if o.mark_duplicates:
            fb = mark_duplicates_batch(fb, genome.contig_offsets,
                                       keep=o.keep_duplicates)
        realigned = 0
        if o.realign_gaps != "no":
            changed = realign_batch(fb, genome,
                                    max_gaps=o.realigned_gaps_per_fragment,
                                    realign_dodgy=o.realign_dodgy)
            realigned += changed
            # --realign-vigorously: newly created gaps feed another
            # harvest+realign round (strictly-better acceptance
            # converges; 3 extra passes bound pathological bins)
            extra = 0
            while o.realign_vigorously and changed and extra < 3:
                changed = realign_batch(
                    fb, genome, max_gaps=o.realigned_gaps_per_fragment,
                    realign_dodgy=o.realign_dodgy)
                realigned += changed
                extra += 1
        return fb, realigned

    def _emit_fb(self, fb, writers: dict, contigs) -> None:
        """Write a coordinate-ordered columnar batch to sorted.bam."""
        from ..build.records import apply_tag_exclusions
        from ..io.bam import BamWriter

        w = writers.get(None)
        if w is None:
            o = self.opts
            w = writers[None] = BamWriter(
                self.out / "sorted.bam", contigs,
                compression_level=o.compression_level, sample=o.sample,
                pu=self._pu_field(o.sample), description=o.description,
                reference_name=o.reference_name,
                extra_tags=tuple(o.bam_header_tags))
        w.write_fragment_batch(apply_tag_exclusions(fb,
                                                    self.opts.excluded_tags()))

    def _phase_bam(self) -> None:
        """Per-bin sort/dedup/realign + streaming BAM serialization
        (reference Build::sortBinParallel, lib/build/Build.cpp:509-903).
        Bins are processed in genome order so the concatenated output is
        globally coordinate-sorted; every step is columnar numpy.

        Three stages overlap (the reference's bin slots,
        Build.cpp:793-903): a loader thread reads bin i+1's chunk files
        while the main thread sorts/dedups/realigns bin i and an ordered
        writer stage serializes bin i-1 to BAM/BGZF.  The trailing
        unaligned bin streams in bounded chunk groups in arrival order (it
        needs no sort: its records carry no coordinates, and arrival order
        is deterministic for a given input)."""
        from ..build.records import FragmentBatch
        from ..build.records import concat as _rconcat
        from ..build.storage import BinnedFragmentStore
        from ..utils.pipeline import OrderedStage, prefetch_iter

        t0 = time.time()
        genome = self._genome()
        bins_dir = self.temp / "bins"
        bin_dirs = sorted(
            d for d in bins_dir.iterdir()
            if d.is_dir() and d.name.startswith("bin_")
        ) if bins_dir.is_dir() else []
        unal = bins_dir / "unaligned"
        cap = self._stats.get("records_per_bin") or self.opts.records_per_bin

        writers: dict = {}
        realigned = dup = n_records = max_bin = 0

        o = self.opts
        keep_unal = o.keep_unaligned
        if keep_unal not in ("discard", "front", "back"):
            raise ValueError(
                f"--keep-unaligned {keep_unal!r}: want discard|front|back")
        bin_filter = self._bin_regex_filter(genome)

        # RAM chunk cache from an in-process align phase (disk fallback
        # covers resume; build/storage.py BinnedFragmentStore cache)
        cache = self._bin_cache

        def load_aligned(d):
            if cache is not None:
                fb = cache.cached_bin(d.name)
                if fb is not None:
                    return fb
            return BinnedFragmentStore.load_bin(d)

        def unal_jobs():
            if keep_unal == "discard" or not unal.is_dir():
                return
            chunks = cache.cached_chunks("unaligned") if cache else None
            if chunks is not None:
                group, rows = [], 0
                for fb in chunks:
                    if group and rows + len(fb) > cap:
                        yield False, _rconcat(group)
                        group, rows = [], 0
                    group.append(fb)
                    rows += len(fb)
                if group:
                    yield False, _rconcat(group)
                return
            for fb in BinnedFragmentStore.iter_chunk_groups(unal, cap):
                yield False, fb

        def jobs():
            # --keep-unaligned front: unaligned clusters lead the BAM
            # (the reference crafts its .bai to skip them, manual.md:204)
            if keep_unal == "front":
                yield from unal_jobs()
            for d in bin_dirs:
                if bin_filter is not None and not bin_filter(d):
                    continue
                yield True, load_aligned(d)
            if keep_unal == "back":
                yield from unal_jobs()

        emit = OrderedStage(
            lambda fb: self._emit_fb(fb, writers, genome.contigs),
            window=max(1, o.output_parallel_save), name="isaac-bam")
        try:
            for is_bin, fb in prefetch_iter(jobs(), depth=1):
                if is_bin:
                    max_bin = max(max_bin, len(fb))
                    fb, r_cnt = self._process_bin_fb(fb, genome)
                    realigned += r_cnt
                dup += int(((fb.flag & sam.FLAG_DUPLICATE) != 0).sum())
                n_records += len(fb)
                emit.submit(fb)
        finally:
            emit.close()
        # post-hoc --memory-limit audit: the distribution-driven bin cuts
        # should have held every bin near its record budget
        if max_bin > 2 * cap:
            from ..utils import tracing
            tracing.log(f"bin budget exceeded: largest bin {max_bin} "
                        f"records vs {cap} budgeted (coverage hotspot "
                        f"narrower than one histogram span)", force=True)
            if o.memory_control == "strict":
                # reference --memory-control strict (manual.md:429)
                from ..utils.errors import MemoryError_
                raise MemoryError_(
                    f"--memory-control strict: bin of {max_bin} records "
                    f"exceeds twice the {cap}-record budget")
        if not writers:
            # no records at all: still emit a valid empty BAM
            self._emit_fb(FragmentBatch.empty(0, 1), writers, genome.contigs)
        for w in writers.values():
            w.close()

        # the RAM chunk cache is single-use (batches may be mutated
        # downstream; a rewound align phase rebuilds it)
        self._bin_cache = None
        if o.cleanup_intermediary:
            # reference --cleanup-intermediary (manual.md:329): erase the
            # consumed bin chunks; bin-level resume is gone (like the
            # reference, --start-from Align still works)
            import shutil
            shutil.rmtree(self.temp / "bins", ignore_errors=True)
        self._stats["build"] = {"records": n_records, "duplicates": dup,
                                "realigned": realigned,
                                "bins": max(1, len(bin_dirs)),
                                "max_bin_records": max_bin,
                                "build_seconds": round(time.time() - t0, 2)}
        (self.stats_dir / "BuildStats.json").write_text(
            json.dumps(self._stats["build"], indent=2))
        from . import reports
        reports.write_build_stats_xml(self._stats["build"],
                                      self.stats_dir / "BuildStats.xml")

    # -- state machine ------------------------------------------------------

    def step(self) -> None:
        from ..utils import tracing
        transitions = {"Start": (self._phase_tls, "TlsDone"),
                       "TlsDone": (self._phase_align, "AlignDone"),
                       "AlignDone": (self._phase_reports, "ReportsDone"),
                       "ReportsDone": (self._phase_bam, "BamDone")}
        if self.state not in transitions:
            raise RuntimeError(f"cannot step from {self.state}")
        fn, next_state = transitions[self.state]
        with tracing.phase(f"workflow {self.state} -> {next_state}"):
            fn()
        self.state = next_state

    def _fit_batch_size(self) -> None:
        """RAM-fit batch selection (reference SeedMemoryManager
        selectTiles, include/alignment/SeedMemoryManager.hh:40-60): cap
        the batch so in-flight device inputs + host result buffers stay
        inside a slice of --memory-limit.  Per row (250bp worst case):
        ~2 ends x 250 B bases/quals x ~4 copies (original, masked,
        oriented, result) + ~600 B of result columns ~ 5 KB; 3 batches
        are in flight (dispatch window + polish + convert)."""
        o = self.opts
        if o.clusters_at_a_time:
            # reference --clusters-at-a-time (manual.md:339): explicit
            # batch size wins over any RAM-based auto selection
            self.opts = dataclasses.replace(
                o, batch_size=o.clusters_at_a_time)
            return
        if not o.memory_limit:
            return
        per_row = 5_000 * 3
        fit = max(256, int(o.memory_limit * 1e9 * 0.15 / per_row))
        if fit < o.batch_size:
            from ..utils import tracing
            tracing.log(f"--memory-limit {o.memory_limit}G: "
                        f"batch_size {o.batch_size} -> {fit}")
            self.opts = dataclasses.replace(o, batch_size=fit)

    def run(self, start_from: str | None = None, stop_at: str = "BamDone",
            resume: bool = False) -> None:
        # the card (or the CPU) must exist before any work: "cuda" without
        # a card raises here, never falls back
        require_device(self.opts.device)
        self._check_base_calls_format()
        self._fit_batch_size()
        if resume:
            self.load_state()
        if start_from:
            self.rewind(start_from)
        while STATES.index(self.state) < STATES.index(stop_at):
            self.step()
            self.save_state()
