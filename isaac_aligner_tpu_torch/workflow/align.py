"""The checkpointed alignment workflow: reads to sorted BAM.

Port of `isaac_aligner_tpu/workflow/align.py` (reference
workflow::AlignWorkflow, src/c++/include/workflow/AlignWorkflow.hh:64-292),
every input and mode of it: a phase state machine
whose state serializes to Temp/AlignerState.json after every completed
phase, with --start-from / --stop-at rewind semantics.  `STATES` and the
on-disk layout of Temp/ (AlignerState.json, bins/bin_*/chunk_*.cols,
bins/boundaries.json) are the JAX package's, so a run can be resumed, and
the BAM, its .bai and its .md5 are byte-equal to the JAX workflow's on the
same inputs.

    Start -> TlsDone      pairs: template-length statistics learned from
                          the first batches (or --tls; --per-tile-tls adds
                          one model per run-folder tile), saved with the
                          state
          -> AlignDone    align all batches on `device`; columnar records
                          stream to genomic bins (output process)
          -> ReportsDone  stats JSON/XML + HTML report
          -> BamDone      per bin: coordinate sort, duplicate marking,
                          known-gap realignment; BGZF BAM + .bai + .md5

The reads come from FASTQ (a file, a pair of files, or a directory of
lane<N>_read<R>.fastq[.gz] files; a barcode FASTQ beside them), an
Illumina BCL run folder (`io/bcl.py`, tile by tile, both layouts, with
--use-bases-mask, --tiles and the lane and tile subsets) or an existing
BAM (`io/bam_input.py`, streamed with a cross-chunk mate cache).  A sample
sheet demultiplexes the run: barcodes resolve in the output process, and
each sample gets its own out/<sample>/sorted.bam, its own duplicate
library and its own gap-realignment scope; a sheet with per-barcode
reference or adapter columns runs one sub-workflow per sample instead
(`workflow/per_barcode.py`).  Decoding and barcode matching stay on the
host; every input reaches the card as the same fixed-shape read batches.

The reference is a saved index directory, a FASTA (built in memory; one
over `group_limit` bases splits into contig groups), a grouped directory
from `sort-reference` (`multi-reference.json`), or comma-separated entries
of these.  More than one index aligns through `parallel/multi_index.py`
with every group's planes on the card, or group-major (one group at a
time) when the planes exceed `device_memory_budget`.

`--devices N` aligns over an N-device [data, shard] mesh
(`parallel/sharded_aligner.py`; `--shard-genome` position-shards the
genome planes too) and marks duplicates collectively in the Build phase.
`--dist-processes P` runs P processes (`parallel/multihost.py`): each
aligns every P-th batch on its own devices (its local mesh under
`--devices N`) and writes its bin chunks, named by global batch number,
to the shared Temp/bins; process 0 then writes the reports and runs the
Build phase alone, so the BAM is byte-equal to a single-process
`uniform_bins` run with the same `--devices`.  The JAX workflow pads a
ragged tail with an all-pad batch because its program spans every
process; here no device work crosses processes, so none is needed.
--per-tile-tls does not combine with processes (it raises, as in JAX).

The aligner runs on `device` ("cuda" by default; "cuda" without a card,
or more devices than the visible cards, raises before any work).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from pathlib import Path

import numpy as np

from ..align.pairs import TlsStatic
from ..align.pipeline import (AlignConfig, default_seed_offsets, plane_bytes,
                              runs_neighbor_pass)
from ..aligner import Aligner, PairedAligner
from ..build.storage import DistributionBinStore
from ..device import require_device
from ..index.build import SeedIndex, build_index
from ..io import sam
from ..io.fasta import read_fasta
from ..io.fastq import ReadBatch, pad_batch

STATES = ("Start", "TlsDone", "AlignDone", "ReportsDone", "BamDone")

#: The device bytes a batch holds beside the index planes at its peak, for
#: a batch of `templates` (single-end reads, or pairs) of `read_len`
#: bases a read against `groups` resident contig groups, with or without
#: the seed stage's neighbor pass (`neighbors`):
#:
#:     WS_FIXED + templates * (
#:         WS_TEMPLATE + WS_TEMPLATE_PER_BASE * read_len
#:         + (groups - 1) * (WS_GROUP + WS_GROUP_PER_BASE * read_len)
#:         + neighbors * (WS_NEIGHBOR + WS_NEIGHBOR_PER_BASE * read_len))
#:
#: (each further group's dispatched outputs stay alive until the batch's
#: last group is finished; the neighbor pass gathers `neighbor_scan_cap`
#: records a seed and widens each seed's hit list from `max_hits_per_seed`
#: slots to that plus `neighbor_scan_cap`, through the sort-dedup; WS_FIXED
#: holds what does not grow with the batch, such as the rescue's capped
#: chunks).  The batch's device program replays as a CUDA graph
#: (`graphs.py`), whose memory pool holds its temporaries for good, so the
#: polish and the rescue allocate beside them, not in their place.  Fitted
#: by `scripts/torch_working_set.py` as an upper envelope, single-end and
#: paired, at 100, 150 and 251 bp, 4,096 to 65,536 templates, one index,
#: two groups and one index with the neighbor pass, on an H100 80GB HBM3 at
#: 700 W (each constant rounded up), of the lesser of two bounds of the
#: need beside the planes: torch.cuda.max_memory_allocated plus the bytes
#: the graph pool holds free, and torch.cuda.max_memory_reserved.  A read
#: takes about as much as a pair's two ends: the model gives a 100 bp
#: template 46.1 kB, 78.1 kB with the neighbor pass.
WS_FIXED = 300_389_880
WS_TEMPLATE = 23_454
WS_TEMPLATE_PER_BASE = 226
WS_GROUP = 0
WS_GROUP_PER_BASE = 123
WS_NEIGHBOR = 12_821
WS_NEIGHBOR_PER_BASE = 192


def batch_working_set(templates: int, read_len: int, groups: int,
                      neighbors: bool = False) -> int:
    """Device bytes a batch needs beside the planes (the model above)."""
    return WS_FIXED + templates * (
        WS_TEMPLATE + WS_TEMPLATE_PER_BASE * read_len
        + (groups - 1) * (WS_GROUP + WS_GROUP_PER_BASE * read_len)
        + neighbors * (WS_NEIGHBOR + WS_NEIGHBOR_PER_BASE * read_len))


def device_memory_budget(device, templates: int, read_len: int,
                         groups: int, neighbors: bool) -> int:
    """Bytes of index planes that `device` can hold beside a batch of
    `templates` reads or pairs of `read_len` bases against `groups`
    resident groups, with or without the neighbor pass: on a card, its
    free memory (torch.cuda.mem_get_info) less the batch's working set; on
    the CPU, the host's physical memory."""
    import torch

    dev = require_device(device)
    if dev.type == "cuda":
        free, _total = torch.cuda.mem_get_info(dev)
        return free - batch_working_set(templates, read_len, groups,
                                        neighbors)
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


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
    """The JAX workflow's options, field for field, plus `device`; each
    acts here as it does there (an option of another input, such as a BCL
    one on a FASTQ run, has no effect in either)."""

    reference: str                      # FASTA path or saved index directory
    output_dir: str
    fastq1: str | None = None
    fastq2: str | None = None           # paired-end when set
    bam_input: str | None = None        # realign from an existing BAM
    run_folder: str | None = None       # BCL run folder (Illumina input)
    # lane subset of a run folder or of a FASTQ lane directory
    lanes: tuple[int, ...] | None = None
    tiles: tuple[int, ...] | None = None    # BCL tile subset
    pf_only: bool = True                # BCL: drop non-pass-filter clusters
    use_bases_mask: str | None = None   # BCL: y/n/i per-cycle mask grammar
    # BCL: missing cycle files read as N / missing filters as all-PF
    ignore_missing_bcls: bool = False
    ignore_missing_filters: bool = False
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
    # demultiplexing: CSV with barcode,sample[,project,lane,reference,
    # adapter]; the index (I1) FASTQ of a FASTQ run, in read-1 order; the
    # mismatches allowed per barcode component
    sample_sheet: str | None = None
    barcode_fastq: str | None = None
    barcode_mismatches: int = 1
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
    # SPMD over an N-device [data, shard] mesh (0/1 single device, -1 all
    # visible devices; on "cpu", N entries of the CPU)
    devices: int = 0
    shard_genome: bool = False          # SPMD only
    keep_unaligned: str = "back"
    mapq_threshold: int = 0
    gapped_mismatches: int = 5
    semialigned_gap_limit: int = 100
    shadow_scan_range: int = -1         # paired only
    realigned_gaps_per_fragment: int = 4
    # 0: each lane its own duplicate library (BCL: lanes from read names)
    single_library_samples: bool = True
    qscore_bin: bool = False
    qscore_bin_values: str = ("0:0,1:1,2-9:6,10-19:15,20-24:22,25-29:27,"
                              "30-34:33,35-39:37,40-63:40")
    variable_read_length: bool = False
    bin_regex: str = "all"
    bam_header_tags: tuple[str, ...] = ()
    input_parallel_load: int = 2
    output_parallel_save: int = 2
    # BCL paired-end: one TLS model per tile (an extra pass over the tiles)
    per_tile_tls: bool = False
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
    tiles_regex: str | None = None      # BCL: regexes over tile numbers
    # multi-process runs: the gloo coordinator host:port, the process count
    # (> 1 enables them) and this process's id (or ISAAC_TPU_DIST_* env)
    dist_coordinator: str | None = None
    dist_processes: int = 0
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


class AlignWorkflow:
    def __init__(self, opts: WorkflowOptions):
        self.opts = opts
        self.out = Path(opts.output_dir)
        self.temp = self.out / "Temp"
        self.stats_dir = self.out / "Stats"
        for d in (self.out, self.temp, self.stats_dir):
            d.mkdir(parents=True, exist_ok=True)
        self.state = "Start"
        self._reads_cache = None
        self._demux_cache = None
        # a per-barcode sub-workflow's demultiplexed batch stream
        # (workflow/per_barcode.py)
        self._stream_factory = None
        self.tls: TlsStatic | None = None
        # --per-tile-tls: (lane, tile) -> TlsStatic fields
        self.tls_by_tile: dict | None = None
        self._index: list[SeedIndex] | None = None
        self._stats: dict = {}
        self._bin_cache = None

    # -- state (de)serialization -------------------------------------------

    @property
    def state_file(self) -> Path:
        return self.temp / "AlignerState.json"

    def save_state(self) -> None:
        if self._dist[1] > 1 and self._dist[0] != 0:
            return   # process 0 owns the shared state file
        doc = {"state": self.state, "stats": self._stats}
        if self.tls is not None:
            doc["tls"] = dataclasses.asdict(self.tls)
        if self.tls_by_tile:
            doc["tls_by_tile"] = {f"{k[0]}:{k[1]}": v
                                  for k, v in self.tls_by_tile.items()}
        self.state_file.write_text(json.dumps(doc, indent=2))

    def load_state(self) -> None:
        if self.state_file.exists():
            doc = json.loads(self.state_file.read_text())
            self.state = doc["state"]
            self._stats = doc.get("stats", {})
            if "tls" in doc:
                self.tls = TlsStatic(**doc["tls"])
            if "tls_by_tile" in doc:
                self.tls_by_tile = {tuple(k.split(":")): v
                                    for k, v in doc["tls_by_tile"].items()}

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

    @property
    def _dist(self) -> tuple[int, int]:
        """(process id, process count): joins the gloo process group on
        first use when the multi-process options (or ISAAC_TPU_DIST_*
        env) ask for it."""
        if getattr(self, "_dist_cached", None) is None:
            o = self.opts
            if o.dist_processes > 1 or os.environ.get("ISAAC_TPU_DIST_NPROCS"):
                from ..parallel.multihost import init_distributed
                self._dist_cached = init_distributed(
                    o.dist_coordinator, o.dist_processes or None,
                    o.dist_process_id if o.dist_process_id >= 0 else None)
            else:
                self._dist_cached = (0, 1)
        return self._dist_cached

    def _n_devices(self) -> int:
        """--devices resolved: -1 is every visible card (one on "cpu").
        More than the visible cards raise ValueError."""
        import torch

        n = self.opts.devices
        if n in (0, 1):
            return n
        dev = require_device(self.opts.device)
        avail = torch.cuda.device_count() if dev.type == "cuda" else 1
        if n == -1:
            n = avail
        if dev.type == "cuda" and n > avail:
            raise ValueError(f"--devices {n}: only {avail} devices visible")
        return n

    def _mesh(self):
        """The [data, shard] mesh when --devices asks for SPMD (cached);
        None on one device.  A multi-process run's mesh is its process's
        devices in one data row (`multihost.local_mesh`); with one device
        a process each process runs the single-device drivers, the program
        of a single-process run, so the BAM equals that run's even where
        the SPMD drivers differ from them (ROADMAP §C4)."""
        if self._n_devices() in (0, 1):
            return None
        if getattr(self, "_mesh_cached", None) is None:
            from ..parallel.multihost import local_mesh
            from ..parallel.sharded import make_mesh
            dev = require_device(self.opts.device)
            self._mesh_cached = (local_mesh(self._n_devices(), dev)
                                 if self._dist[1] > 1
                                 else make_mesh(self._n_devices(), device=dev))
        return self._mesh_cached

    def _load_indexes(self) -> list[SeedIndex]:
        """One index per comma-separated --reference entry; a grouped
        directory gives its groups (memory-mapped), a FASTA over
        `group_limit` bases one index per contig group."""
        if self._index is None:
            from ..index.groups import (is_grouped_reference,
                                        load_grouped_indexes,
                                        split_genome_groups, subset_genome)
            indexes = []
            for part in str(self.opts.reference).split(","):
                ref = Path(part)
                if ref.is_dir() and is_grouped_reference(ref):
                    # memory-mapped: a group's pages stream through the
                    # page cache during its upload instead of living in RSS
                    indexes.extend(load_grouped_indexes(ref, mmap=True))
                elif ref.is_dir():
                    indexes.append(SeedIndex.load(ref))
                else:
                    genome = read_fasta(ref)
                    groups = split_genome_groups(genome.contigs,
                                                 limit=self.opts.group_limit)
                    # 64-mer seeds search a 32-mer index + extension verify
                    sl = min(self.opts.seed_len, 32)
                    if len(groups) == 1:
                        indexes.append(build_index(genome, seed_len=sl))
                    else:
                        indexes.extend(
                            build_index(subset_genome(genome, names),
                                        seed_len=sl)
                            for names in groups)
            self._index = indexes
        return self._index

    def _load_index(self) -> SeedIndex:
        return self._load_indexes()[0]

    def _genome(self):
        """The (combined) genome for the output phases: positions of a
        multi-index run are global over the concatenated groups."""
        idxs = self._load_indexes()
        if len(idxs) == 1:
            return idxs[0].genome
        from ..parallel.multi_index import _combined_genome
        return _combined_genome([ix.genome for ix in idxs])

    @property
    def _paired(self) -> bool:
        """A run folder with two data reads, a BAM of paired records (its
        whole read set is loaded to tell, as in JAX), or a second FASTQ."""
        if self.opts.run_folder:
            from ..io.bcl import parse_run_info
            info = parse_run_info(Path(self.opts.run_folder))
            return len(info.data_reads) >= 2
        if self.opts.bam_input:
            return self._load_all_reads()[1] is not None
        if self.opts.fastq1 and Path(self.opts.fastq1).is_dir():
            files = self._fastq_lane_files()
            return bool(files) and files[0][1] is not None
        return bool(self.opts.fastq2)

    def _load_all_reads(self):
        """(read-1 batch, read-2 batch or None) of a whole BAM input, kept:
        the pairedness probe and the read count of a BAM run (the
        streamed batches come from `_raw_batch_stream`)."""
        if self._reads_cache is None:
            from ..io.bam_input import reads_from_bam
            self._reads_cache = reads_from_bam(self.opts.bam_input)
        return self._reads_cache

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
        # align phase do not enter it.  It runs on the largest contig group
        # (TLS is a library property) and frees the card for the align phase
        index = max(self._load_indexes(),
                    key=lambda ix: ix.genome.total_length)
        read_len = learn[0][0].read_len
        aligner = PairedAligner.create(
            index, read_len=read_len, cfg=self._align_config(read_len, index),
            device=self.opts.device)
        self.tls = aligner.learn_tls(learn)
        self._apply_mate_drift()
        self._stats["tls"] = dataclasses.asdict(self.tls)
        if self.opts.per_tile_tls and self.opts.run_folder:
            self._learn_per_tile_tls(aligner)
        aligner.release_device()

    @staticmethod
    def _tile_key_of(name: str) -> tuple[str, str] | None:
        """(lane, tile) from an Illumina read name, or None."""
        parts = name.split(":")
        return (parts[3], parts[4]) if len(parts) >= 5 else None

    def _learn_per_tile_tls(self, aligner) -> None:
        """--per-tile-tls: one extra pass over the (tile-ordered) BCL
        stream learning a model per tile from its first tls_batches
        batches (reference: MatchSelector::determineTemplateLength runs
        per tile, MatchSelector.cpp:188-256).  The align phase's feed
        hangs each tile's model on its batches (`tls_hint`), which every
        aligner's `_batch_tls` reads.  As in JAX, the hint takes no
        --mate-drift-range, and the host rescue of the single-device
        drivers reads the global model: it receives the masked copies of
        the batch, which carry no hint."""
        by_tile: dict = {}
        cur = None
        collected: list = []

        def finish(key, batches):
            if key is None or not batches:
                return
            aligner.learn_tls(batches)
            by_tile[key] = dataclasses.asdict(aligner.tls)

        for b1, b2, _bc in self._batch_stream():
            key = self._tile_key_of(b1.names[0])
            if key != cur:
                finish(cur, collected)
                cur, collected = key, []
            if len(collected) < self.opts.tls_batches:
                collected.append((b1, b2))
        finish(cur, collected)
        self.tls_by_tile = by_tile
        self._stats["tls_per_tile"] = {f"{k[0]}:{k[1]}": v
                                       for k, v in by_tile.items()}

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
        from .stats_agg import coords_from_names, tile_agg

        index = self._load_index()
        indexes = self._load_indexes()
        t0 = time.time()
        pid, nproc = self._dist
        mh = nproc > 1
        mesh = self._mesh()
        if mesh is not None and self.opts.batch_size % mesh.shape["data"]:
            # every data row takes an equal share of a batch
            d = mesh.shape["data"]
            self.opts = dataclasses.replace(
                self.opts, batch_size=-(-self.opts.batch_size // d) * d)
        o = self.opts
        if mh and o.per_tile_tls:
            raise ValueError("--per-tile-tls does not combine with "
                             "multi-host execution yet")
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
        cfg = self._align_config(read_len, index)
        common = dict(read_len=read_len,
                      cfg=cfg,
                      device=o.device,
                      base_quality_cutoff=o.base_quality_cutoff,
                      clip_semialigned=o.clip_semialigned,
                      adapters=tuple(o.adapters),
                      gap_scoring=GapScoring.parse(o.gap_scoring),
                      gapped_mismatches=o.gapped_mismatches,
                      semialigned_gap_limit=o.semialigned_gap_limit,
                      avoid_smith_waterman=o.avoid_smith_waterman)
        paired_kw = dict(clip_overlapping=o.clip_overlapping,
                         pessimistic_mapq=o.pessimistic_mapq,
                         shadow_scan_range=o.shadow_scan_range)
        groups = None
        if (mh or mesh is not None) and len(indexes) > 1:
            raise ValueError(
                "--devices SPMD does not combine with contig-group "
                "(multi-index) references yet; use a single-group index")
        if mesh is not None:
            from ..parallel.sharded_aligner import (ShardedAligner,
                                                    ShardedPairedAligner)
            spmd = dict(index=index, mesh=mesh, genome_sharded=o.shard_genome,
                        **{k: v for k, v in common.items() if k != "device"})
            aligner = (ShardedPairedAligner.create_sharded(
                **spmd, **paired_kw) if paired
                else ShardedAligner.create_sharded(**spmd))
        elif len(indexes) > 1:
            from ..parallel.multi_index import (MultiIndexAligner,
                                                MultiIndexPairedAligner)
            from ..utils import tracing
            # beyond the card's memory: one group's planes resident at a
            # time (parallel/multi_index._group_major_many)
            need = sum(plane_bytes(ix) for ix in indexes)
            budget = device_memory_budget(o.device, o.batch_size, read_len,
                                          len(indexes),
                                          runs_neighbor_pass(cfg))
            gm = need > budget
            if gm:
                tracing.log(
                    f"multi-index: {need / 1e9:.2f} GB of index planes > "
                    f"{budget / 1e9:.2f} GB budget on {o.device}: "
                    f"group-major (one group resident at a time)",
                    force=True)
            if paired:
                aligner = MultiIndexPairedAligner.create(
                    indexes, group_major=gm, **paired_kw, **common)
            else:
                aligner = MultiIndexAligner.create(indexes, group_major=gm,
                                                   **common)
            groups = aligner.aligners
        elif paired:
            aligner = PairedAligner.create(index, **paired_kw, **common)
        else:
            aligner = Aligner.create(index, **common)
        if paired and self.tls is not None:
            aligner.tls = self.tls

        rg_names = self._demux_names()
        records_per_bin = self._records_per_bin(read_len)
        self._stats["records_per_bin"] = records_per_bin
        n_bins = max(1, -(-self._estimate_total_reads() * ends
                          // records_per_bin))
        bins_dir = self.temp / "bins"
        if mh:
            from ..parallel import multihost
            if pid == 0 and bins_dir.exists():
                shutil.rmtree(bins_dir)
            multihost.barrier("bins_cleared")
        elif bins_dir.exists():
            shutil.rmtree(bins_dir)
        store = DistributionBinStore(
            bins_dir, genome.contig_offsets, genome.total_length, n_bins,
            sample_cap=max(records_per_bin, 4 * o.batch_size * ends),
            # multi-process: every process cuts the same (uniform) bins,
            # and a process's RAM cache cannot serve process 0's Build
            ram_cache_records=(0 if mh else
                               records_per_bin if o.buffer_bins else 0),
            pre_sort=o.pre_sort_bins, uniform=mh or o.uniform_bins)
        # the Build phase reuses the RAM chunk cache when it runs in this
        # process (resume-from-disk falls back to the files)
        self._bin_cache = store

        stats = {"total_reads": 0, "aligned": 0, "perfect": 0,
                 "proper_pairs": 0, "mapq_hist": np.zeros(61, np.int64)}
        per_tile: dict[tuple[str, str], dict] = {}
        demux_counts = np.zeros(len(rg_names) or 1, np.int64)
        # the barcode/name sidecar rides a queue so the aligner's input
        # stays a plain batch iterator
        sidecar: deque = deque()
        t_host = {"parse": 0.0, "convert": 0.0}
        tls_by_tile = self.tls_by_tile

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
                if mh and gidx % nproc != pid:
                    continue   # another process's stripe
                b1, b2, bc = nxt
                # names stay columnar/lazy for FASTQ (run folders give
                # strings); conversion needs the count
                sidecar.append((bc, b1.names, b1.n_valid, gidx))
                if tls_by_tile and paired:
                    # --per-tile-tls: this tile's model rides the batch
                    # object itself to every aligner's _batch_tls
                    doc = tls_by_tile.get(self._tile_key_of(b1.names[0]))
                    if doc is not None:
                        b1.tls_hint = TlsStatic(**doc)
                yield (b1, b2) if paired else b1

        def aux_for(bc_bases, names, n_valid: int):
            """The sample sheet's RG/BC columns and the run folder's ZX/ZY
            of one batch, or None."""
            rg = bc = zx = zy = None
            if rg_names:
                rg, bc = self._resolve_rg(bc_bases, n_valid)
            if o.run_folder and not {"ZX", "ZY"} <= o.excluded_tags():
                zx, zy = coords_from_names(list(names[:n_valid]))
            if rg is None and zx is None:
                return None
            return fstore.AuxColumns(rg=rg, rg_names=rg_names, bc=bc,
                                     zx=zx, zy=zy)

        def convert_emit(inputs, res):
            t1 = time.perf_counter()
            bc_bases, names, n_valid, gidx = sidecar.popleft()
            aux = aux_for(bc_bases, names, n_valid)
            if paired:
                fb = fstore.from_paired_result(
                    genome, inputs[0], inputs[1], res,
                    mapq_cap=aligner.cfg.mapq_cap, aux=aux,
                    pessimistic=o.pessimistic_mapq,
                    mapq_threshold=o.mapq_threshold)
            else:
                fb = fstore.from_single_result(
                    genome, inputs, res, mapq_cap=aligner.cfg.mapq_cap,
                    aux=aux, mapq_threshold=o.mapq_threshold)
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
            if rg_names:
                first = (fb.flag & sam.FLAG_READ2) == 0
                np.add.at(demux_counts, np.maximum(fb.rg[first], 0), 1)
            if o.run_folder:
                valid = list(names[:n_valid])
                rec_names = np.repeat(np.asarray(valid, dtype="U"),
                                      len(fb) // max(len(valid), 1))
                tile_agg(rec_names, fb, mapped, per_tile, rg_names)
            else:
                # FASTQ/BAM inputs: one synthesized tile per batch, as the
                # reference's FastqDataSource.hh:41-118 does
                tile_agg(None, fb, mapped, per_tile, rg_names,
                         synth_tile=("1", f"{gidx:04d}"))
            store.add(fb, seq=gidx)
            t_host["convert"] += time.perf_counter() - t1

        batches = prefetch_iter(feed(), depth=max(1, o.input_parallel_load))
        if op.enabled() and not mh:
            specs, spec_to_name, unknown, _ = self._demux_setup()
            excluded = o.excluded_tags()
            proc = op.OutputProcess(dict(
                bins_dir=str(bins_dir),
                contig_offsets=np.asarray(genome.contig_offsets),
                genome_bp=genome.total_length, n_bins=n_bins,
                sample_cap=store.sample_cap, pre_sort=o.pre_sort_bins,
                uniform=bool(o.uniform_bins), rg_names=rg_names,
                mapq_cap=aligner.cfg.mapq_cap, paired=paired,
                pessimistic=o.pessimistic_mapq,
                mapq_threshold=o.mapq_threshold,
                run_folder=bool(o.run_folder),
                want_bc="BC" not in excluded,
                want_zxzy=not {"ZX", "ZY"} <= excluded,
                barcode_mismatches=o.barcode_mismatches,
                specs=specs, spec_to_name=spec_to_name, unknown=unknown))

            def submit_proc(inputs, res):
                t1 = time.perf_counter()
                bc_bases, names, n_valid, gidx = sidecar.popleft()
                if not isinstance(names, LazyNames):
                    names = LazyNames.from_list(list(names))
                b1 = inputs[0] if paired else inputs
                b2 = inputs[1] if paired else None
                res2 = {k: v for k, v in res.items()
                        if not k.startswith("cand_")}
                proc.submit((gidx, n_valid, names.mat, names.lens, bc_bases,
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
            demux_counts += np.asarray(out["demux_counts"], np.int64)
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
            store.finalize(write_meta=not mh or pid == 0)
        if mh:
            # totals over the processes (each counted its own rows once);
            # every chunk is on disk before the barrier lets process 0
            # into the Build phase
            from ..parallel.multihost import allsum_stats, barrier
            merged = allsum_stats({k: stats[k] for k in (
                "total_reads", "aligned", "perfect", "proper_pairs",
                "mapq_hist")})
            for k, v in merged.items():
                stats[k] = v if k == "mapq_hist" else int(v)
            demux_counts[:] = allsum_stats({"d": demux_counts})["d"]
            fs = aligner.finder_stats
            if fs:
                ints = {k: v for k, v in fs.items() if isinstance(v, int)}
                for k, v in allsum_stats(ints).items():
                    fs[k] = int(v)
                fs.pop("tally", None)   # per-process batch lists
            barrier("align_done")

        if rg_names:
            counts = {nm: int(c) for nm, c in zip(rg_names, demux_counts)
                      if c}
            self._stats["demultiplexing"] = counts
            if not mh or pid == 0:
                (self.stats_dir / "DemultiplexingStats.json").write_text(
                    json.dumps(counts, indent=2))
        if per_tile:
            # multi-process: this process's stripe of tiles
            stats["tiles"] = [
                {"lane": lane, "tile": tile, "barcode": sample,
                 "read": read, **agg}
                for (lane, tile, sample, read), agg in sorted(per_tile.items())]
        stats["align_seconds"] = round(time.time() - t0, 2)
        t_host.update(aligner.timings)
        stats["stage_seconds"] = {k: round(v, 3) for k, v in t_host.items()}
        # device work of the host-driven passes: pairs sent to the banded
        # SW kernel and those whose gapped result was taken, (pairs)
        # orphan rows scanned by the rescue, and the ends and pairs the
        # trim, clip and simple-indel passes changed, and the batches'
        # device programs replayed as CUDA graphs, captured or run eagerly
        stats["device_work"] = {k: getattr(aligner, k) for k in
                                ("sw_pairs", "sw_accepted", "rescue_rows",
                                 "rescue_calls", "trimmed_ends",
                                 "semialigned_clipped", "reclipped",
                                 "overlap_clipped", "indel_moved",
                                 "indel_repaired", "graph_replays",
                                 "graph_captures", "eager_dispatches")
                                if hasattr(aligner, k)}
        if groups is not None:
            # per contig group: its records, the device bytes of its planes
            # and the seconds its uploads took
            stats["groups"] = [
                {"records": a.index.num_records,
                 "plane_bytes": plane_bytes(a.index),
                 "upload_seconds": round(a.timings.get("upload", 0.0), 3)}
                for a in groups]
            stats["group_major"] = aligner.group_major
        stats["mapq_hist"] = [int(x) for x in stats["mapq_hist"]]
        for k in ("total_reads", "aligned", "perfect", "proper_pairs"):
            stats[k] = int(stats[k])
        self._stats["match_selector"] = stats
        if aligner.finder_stats:
            self._stats["match_finder"] = dict(aligner.finder_stats)

    def _pu_field(self, sample_name: str) -> str:
        """--bam-pu-format (manual.md:281): expand %F (the run folder's
        flowcell id; "unknown" for other inputs), %L (lane list) and %B
        (barcode/sample) into the @RG PU field."""
        o = self.opts
        fc = "unknown"
        if o.run_folder:
            from ..io.bcl import parse_run_info
            try:
                fc = parse_run_info(Path(o.run_folder)).flowcell
            except Exception:
                pass
        lanes = ",".join(str(x) for x in o.lanes) if o.lanes else "all"
        return (o.bam_pu_format.replace("%F", fc).replace("%L", lanes)
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
        if fmt in ("bcl", "bcl-gz", "bcl-bgzf") and not o.run_folder:
            raise InvalidOptionError(
                f"--base-calls-format {fmt}: needs --run-folder input")
        if fmt == "bam" and not o.bam_input:
            raise InvalidOptionError(
                "--base-calls-format bam: needs --bam input")
        if fmt.startswith("fastq"):
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

    def _demux_setup(self):
        """(specs, spec index -> sample-name index, unknown index, RG
        names), cached; no sample sheet gives (None, None, 0, ()).
        Reference analog: BarcodeBamMapping construction."""
        if self._demux_cache is None:
            if not self.opts.sample_sheet:
                self._demux_cache = (None, None, 0, ())
            else:
                from ..demultiplexing.samplesheet import (UNKNOWN_SAMPLE,
                                                          parse_sample_sheet)
                specs = parse_sample_sheet(self.opts.sample_sheet)
                sample_names: list[str] = []
                for sp in specs:
                    if sp.sample not in sample_names:
                        sample_names.append(sp.sample)
                unknown = len(sample_names)
                rg_names = tuple(sample_names) + (UNKNOWN_SAMPLE,)
                spec_to_name = np.full(max(sp.index for sp in specs) + 1,
                                       unknown, np.int32)
                for sp in specs:
                    spec_to_name[sp.index] = sample_names.index(sp.sample)
                self._demux_cache = (specs, spec_to_name, unknown, rg_names)
        return self._demux_cache

    def _demux_names(self) -> tuple[str, ...]:
        return self._demux_setup()[3]

    def _resolve_rg(self, bc_bases, n: int):
        """Per-batch barcode resolution -> (rg column, BC ascii or None)."""
        from .. import dna
        from ..demultiplexing.resolver import resolve_barcodes
        specs, spec_to_name, unknown, _ = self._demux_setup()
        if specs is None:
            return None, None
        if bc_bases is None:
            # no index read: everything lands on the unknown sample
            return np.full(n, unknown, np.int32), None
        bidx = resolve_barcodes(bc_bases, specs, self.opts.barcode_mismatches)
        rg = np.where(bidx >= 0, spec_to_name[np.maximum(bidx, 0)],
                      unknown).astype(np.int32)
        bc = None
        if "BC" not in self.opts.excluded_tags():
            bc = dna.CODE_TO_BASE[np.minimum(bc_bases, 4)]
        return rg, bc

    def _bcl_tile_list(self) -> list[tuple[int, int]]:
        """(lane, tile) of every tile the run aligns: --lane and --tile
        subsets (else every lane and tile found), then --tiles regexes
        fullmatched against the 4-digit tile number (manual.md:564)."""
        from ..io.bcl import discover_lanes, discover_tiles
        o = self.opts
        run = Path(o.run_folder)
        lanes = list(o.lanes) if o.lanes else discover_lanes(run)
        out = [(lane, tile) for lane in lanes
               for tile in (list(o.tiles) if o.tiles
                            else discover_tiles(run, lane))]
        if o.tiles_regex:
            import re
            pats = [re.compile(p) for p in o.tiles_regex.split(",") if p]
            out = [(lane, tile) for lane, tile in out
                   if any(p.fullmatch(f"{tile:04d}") for p in pats)]
            if not out and not o.allow_empty_flowcells:
                from ..utils.errors import InvalidOptionError
                raise InvalidOptionError(
                    f"--tiles {o.tiles_regex!r} matched no tiles")
        return out

    def _fastq_lane_files(self) -> "list[tuple[str, str | None]]":
        """--fastq1 as a base-calls DIRECTORY: discover
        lane<N>_read<R>.fastq[.gz] pairs for lanes 1..--lane-number-max
        (reference FastqLayout.cpp:45-66 naming + --lane-number-max,
        manual.md:419).  A plain file path returns (fastq1, fastq2)."""
        o = self.opts
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
        """Read count for bin sizing: cluster-count headers for BCL,
        file-size estimate for streamed FASTQ, exact for a BAM (only bin
        granularity depends on it)."""
        o = self.opts
        if o.run_folder:
            from ..io.bcl import peek_tile_cluster_count
            return sum(peek_tile_cluster_count(o.run_folder, lane, tile)
                       for lane, tile in self._bcl_tile_list())
        if o.fastq1 and not o.bam_input:
            from ..io.fastq import estimate_fastq_reads
            return sum(estimate_fastq_reads(r1)
                       for r1, _ in self._fastq_lane_files())
        return self._load_all_reads()[0].count

    def _batch_stream(self):
        """Yield (b1, b2 | None, barcode_bases | None) padded batches
        with input-side postprocessing on both ends: --qscore-bin quality
        remapping and the --variable-fastq-read-length uniformity check."""
        o = self.opts
        qtab = o.qscore_table()
        for b1, b2, bc in self._raw_batch_stream():
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

    def _raw_batch_stream(self):
        """Yield (b1, b2 | None, barcode_bases | None) padded batches.
        FASTQ streams record block by record block, BCL run folders tile
        by tile (the reference's RAM-fit tile batching, SeedMemoryManager
        / BclSeedSource), BAM BGZF chunk by chunk: bounded RAM for each.
        Barcodes come with the batches only under a sample sheet.

        A per-barcode sub-workflow injects its demultiplexed stream via
        `_stream_factory` (workflow/per_barcode.py)."""
        if self._stream_factory is not None:
            yield from self._stream_factory()
            return
        o = self.opts
        if o.run_folder:
            from ..io.bcl import load_tile, parse_run_info, tile_read_batches
            run = Path(o.run_folder)
            info = parse_run_info(run)
            for lane, tile in self._bcl_tile_list():
                td = load_tile(
                    run, lane, tile, info,
                    use_bases_mask=o.use_bases_mask,
                    ignore_missing_bcls=o.ignore_missing_bcls,
                    ignore_missing_filters=o.ignore_missing_filters)
                batches, bars = tile_read_batches(td, info, o.pf_only)
                if not batches:
                    raise ValueError(f"{run}: no data reads in RunInfo")
                if len(batches) > 2:
                    raise ValueError("more than 2 data reads not supported")
                b1t = batches[0]
                b2t = batches[1] if len(batches) > 1 else None
                bs = o.batch_size
                for lo in range(0, b1t.count, bs):
                    hi = min(lo + bs, b1t.count)
                    yield (self._slice_pad(b1t, lo, hi, bs),
                           self._slice_pad(b2t, lo, hi, bs)
                           if b2t is not None else None,
                           bars[lo:hi] if o.sample_sheet else None)
            return
        if o.fastq1 and not o.bam_input:
            from ..io.fastq import iter_fastq_batches
            for r1, r2 in self._fastq_lane_files():
                yield from iter_fastq_batches(
                    r1, r2, o.batch_size,
                    barcode_path=o.barcode_fastq if o.sample_sheet else None)
            return
        if o.bam_input:
            # streaming BAM source: BGZF chunks + cross-chunk pair cache
            # (BamDataSource.hh:41-155)
            from ..io.bam_input import iter_bam_batches
            yield from iter_bam_batches(o.bam_input, o.batch_size)
            return
        raise ValueError("need --fastq1, --run-folder or --bam input")

    @staticmethod
    def _slice_pad(b: ReadBatch, lo: int, hi: int, bs: int) -> ReadBatch:
        return pad_batch(ReadBatch(b.names[lo:hi], b.bases[lo:hi],
                                   b.quals[lo:hi], b.lengths[lo:hi]), bs)

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
        if "demultiplexing" in self._stats:
            reports.write_demultiplexing_stats_xml(
                self._stats["demultiplexing"],
                self.stats_dir / "DemultiplexingStats.xml")
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

    def _library_ids(self, fb):
        """--single-library-samples 0: per-(sample, lane) library ids for
        duplicate marking; lanes parse from Illumina read names (BCL
        runs).  Default (1): None, the per-sample fb.rg dedup default."""
        if self.opts.single_library_samples or not self.opts.run_folder:
            return None
        names = np.asarray(fb.names(), dtype="U")
        parts = np.char.partition(
            np.char.partition(np.char.partition(names, ":")[:, 2],
                              ":")[:, 2], ":")[:, 2]
        lane_s = np.char.partition(parts, ":")[:, 0]
        lanes = np.zeros(len(fb), np.int64)
        ok = np.char.isdigit(lane_s)
        lanes[ok] = lane_s[ok].astype(np.int64)
        return fb.rg.astype(np.int64) * 64 + lanes

    def _process_bin_fb(self, fb, genome):
        """Sort + dedup + realign one bin, columnar (BinSorter::process).
        A sample sheet makes each sample a duplicate library (each
        (sample, lane) with --single-library-samples 0) and its own
        gap-sharing scope unless --realign-gaps all."""
        from ..build.dedup import coordinate_sort_order, mark_duplicates_batch
        from ..build.realign import realign_batch

        o = self.opts
        fb = fb.take(coordinate_sort_order(fb))
        if o.mark_duplicates:
            lib = self._library_ids(fb)
            # a multi-process Build runs on process 0 alone: per-bin dedup
            mesh = self._mesh() if self._dist[1] == 1 else None
            if mesh is not None:
                from ..build.dedup import mark_duplicates_collective
                fb = mark_duplicates_collective(
                    fb, mesh, keep=o.keep_duplicates, lib=lib)
            else:
                fb = mark_duplicates_batch(fb, genome.contig_offsets,
                                           keep=o.keep_duplicates, lib=lib)
        realigned = 0
        if o.realign_gaps != "no":
            if o.realign_gaps == "all" or not o.sample_sheet:
                scopes = [None]
            else:
                # per-sample (or per-project) gap scope: group on RG
                scopes = [np.nonzero(fb.rg == v)[0] for v in np.unique(fb.rg)]
            for rows in scopes:
                changed = realign_batch(
                    fb, genome, rows, max_gaps=o.realigned_gaps_per_fragment,
                    realign_dodgy=o.realign_dodgy)
                realigned += changed
                # --realign-vigorously: newly created gaps feed another
                # harvest+realign round (strictly-better acceptance
                # converges; 3 extra passes bound pathological bins)
                extra = 0
                while o.realign_vigorously and changed and extra < 3:
                    changed = realign_batch(
                        fb, genome, rows,
                        max_gaps=o.realigned_gaps_per_fragment,
                        realign_dodgy=o.realign_dodgy)
                    realigned += changed
                    extra += 1
        return fb, realigned

    def _emit_fb(self, fb, writers: dict, contigs) -> None:
        """Route a coordinate-ordered columnar batch into the output BAM
        writer(s): one per sample when demultiplexing (BarcodeBamMapping,
        out/<sample>/sorted.bam), one sorted.bam otherwise."""
        from ..build.records import apply_tag_exclusions
        from ..io.bam import BamWriter

        o = self.opts

        def writer_for(key: str | None) -> BamWriter:
            w = writers.get(key)
            if w is None:
                if key is None:
                    path, sample_name = self.out / "sorted.bam", o.sample
                else:
                    d = self.out / key
                    d.mkdir(parents=True, exist_ok=True)
                    path, sample_name = d / "sorted.bam", key
                w = writers[key] = BamWriter(
                    path, contigs, compression_level=o.compression_level,
                    sample=sample_name, pu=self._pu_field(sample_name),
                    description=o.description,
                    reference_name=o.reference_name,
                    extra_tags=tuple(o.bam_header_tags))
            return w

        excl = o.excluded_tags()
        if not o.sample_sheet:
            writer_for(None).write_fragment_batch(
                apply_tag_exclusions(fb, excl))
            return
        for v in np.unique(fb.rg):
            rows = np.nonzero(fb.rg == v)[0]
            key = fb.rg_names[v] if 0 <= v < len(fb.rg_names) else "unknown"
            writer_for(key).write_fragment_batch(
                apply_tag_exclusions(fb.take(rows), excl))

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
        if not writers and not o.sample_sheet:
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
        pid, nproc = self._dist
        if nproc > 1 and pid != 0 and self.state in ("AlignDone",
                                                     "ReportsDone"):
            # process 0 writes the reports and runs the Build phase over
            # every process's chunks; the others wait at the end barrier
            def fn():
                return None
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
        # a sample sheet with per-barcode reference/adapter columns runs
        # one sub-workflow per sample (workflow/per_barcode.py)
        if self.opts.sample_sheet and self._stream_factory is None:
            from .per_barcode import (PerBarcodeDriver,
                                      sheet_has_per_barcode_columns)
            if sheet_has_per_barcode_columns(self.opts.sample_sheet):
                # kept: its per-sample results and device bytes
                self.per_barcode = PerBarcodeDriver(self.opts)
                self.per_barcode.run()
                return
        self._n_devices()
        self._check_base_calls_format()
        self._fit_batch_size()
        if resume:
            self.load_state()
        if start_from:
            self.rewind(start_from)
        while STATES.index(self.state) < STATES.index(stop_at):
            self.step()
            self.save_state()
        if self._dist[1] > 1:
            from ..parallel.multihost import barrier
            barrier("workflow_done")
