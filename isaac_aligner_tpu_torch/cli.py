"""Command-line interface of the port: the `align` subcommand.

Port of the `align` subcommand of `isaac_aligner_tpu/cli.py` (reference
bin/isaac-align, src/c++/bin/isaac-align.cpp:31-151) with the options the
FASTQ paths run (single-end, and paired-end with -2), plus `--device`
(default "cuda"):

    python -m isaac_aligner_tpu_torch align -r index_dir|ref.fa \\
        -1 r1.fastq [-2 r2.fastq] -o out_dir [--device cuda|cpu] \\
        [--start-from State] ...

The index directory comes from the JAX package's `sort-reference` (the
same on-disk files); the port's own `sort-reference` waits for neighbor
annotation (ROADMAP queue A items 6 and 11).
"""

from __future__ import annotations

import argparse
import sys


def _cmd_align(args) -> int:
    from .workflow.align import AlignWorkflow, WorkflowOptions

    opts = WorkflowOptions(
        reference=args.reference,
        output_dir=args.output_directory,
        fastq1=args.fastq1,
        fastq2=args.fastq2,
        lanes=tuple(int(x) for x in args.lane.split(",")) if args.lane else None,
        seed_len=args.seed_length,
        batch_size=args.batch_size,
        neighborhood_size_threshold=args.neighborhood_size_threshold,
        keep_duplicates=not args.remove_duplicates,
        mark_duplicates=not args.no_mark_duplicates,
        sample=args.sample,
        base_quality_cutoff=args.base_quality_cutoff,
        clip_semialigned=not args.no_clip_semialigned,
        clip_overlapping=not args.no_clip_overlapping,
        adapters=tuple(args.adapter or ()),
        realign_gaps=args.realign_gaps,
        gap_scoring=args.gap_scoring,
        seeds=args.seeds,
        repeat_threshold=args.repeat_threshold,
        first_pass_seeds=args.first_pass_seeds,
        dodgy_alignment_score=args.dodgy_alignment_score,
        tls_override=args.tls,
        mate_drift_range=args.mate_drift_range,
        pessimistic_mapq=args.bam_pessimistic_mapq,
        bam_exclude_tags=args.bam_exclude_tags,
        records_per_bin=args.records_per_bin,
        memory_limit=args.memory_limit,
        keep_unaligned=args.keep_unaligned,
        mapq_threshold=args.mapq_threshold,
        gapped_mismatches=args.gapped_mismatches,
        semialigned_gap_limit=args.semialigned_gap_limit,
        shadow_scan_range=args.shadow_scan_range,
        realigned_gaps_per_fragment=args.realigned_gaps_per_fragment,
        qscore_bin=bool(args.qscore_bin),
        variable_read_length=args.variable_fastq_read_length,
        bin_regex=args.bin_regex,
        bam_header_tags=tuple(
            t.replace("\\t", "\t") for t in (args.bam_header_tag or ())),
        compression_level=args.bam_gzip_level,
        input_parallel_load=args.input_parallel_load,
        output_parallel_save=args.output_parallel_save,
        ignore_neighbors=bool(args.ignore_neighbors),
        ignore_repeats=bool(args.ignore_repeats),
        scatter_repeats=bool(args.scatter_repeats),
        avoid_smith_waterman=bool(args.avoid_smith_waterman),
        realign_dodgy=bool(args.realign_dodgy),
        realign_vigorously=bool(args.realign_vigorously),
        cleanup_intermediary=bool(args.cleanup_intermediary),
        memory_control=args.memory_control,
        allow_empty_flowcells=bool(args.allow_empty_flowcells),
        lane_number_max=args.lane_number_max,
        bam_pu_format=args.bam_pu_format,
        reference_name=args.reference_name,
        description=args.description,
        stats_image_format=args.stats_image_format,
        expected_bgzf_ratio=args.expected_bgzf_ratio,
        buffer_bins=bool(args.buffer_bins),
        pre_sort_bins=bool(args.pre_sort_bins),
        base_calls_format=args.base_calls_format,
        clusters_at_a_time=args.clusters_at_a_time,
        device=args.device,
        **({"qscore_bin_values": args.qscore_bin_values}
           if args.qscore_bin_values else {}),
    )
    wf = AlignWorkflow(opts)
    wf.run(start_from=args.start_from, stop_at=args.stop_at,
           resume=args.resume)
    print(f"workflow finished at state {wf.state}; output in "
          f"{args.output_directory}")
    return 0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="isaac_aligner_tpu_torch")
    p.add_argument("--version", action="version",
                   version="isaac_aligner_tpu_torch 0.1.0")
    p.add_argument("-v", "--verbosity", type=int, default=None,
                   help="0 silences phase logs; >=1 enables them "
                        "(equivalent to ISAAC_TPU_LOG=1)")
    sub = p.add_subparsers(dest="command", required=True)

    al = sub.add_parser("align", help="align FASTQ reads to a reference")
    al.add_argument("-r", "--reference", required=True,
                    help="FASTA file or saved index directory")
    al.add_argument("-1", "--fastq1", default=None,
                    help="read-1 FASTQ, or a directory of "
                         "lane<N>_read<1|2>.fastq[.gz] files")
    al.add_argument("-2", "--fastq2", default=None,
                    help="read-2 FASTQ of a paired-end run")
    al.add_argument("--lane", default=None,
                    help="comma-separated lane subset of a --fastq1 "
                         "directory")
    al.add_argument("-o", "--output-directory", required=True)
    al.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card), cuda:N "
                         "or cpu")
    al.add_argument("-s", "--seed-length", type=int, default=32)
    al.add_argument("--batch-size", type=int, default=4096)
    al.add_argument("--neighborhood-size-threshold", type=int, default=0,
                    help="enable Hamming<=1 neighbor seed matching for"
                         " prefix blocks up to this size (0 disables)")
    al.add_argument("--sample", default="sample")
    al.add_argument("--remove-duplicates", action="store_true")
    al.add_argument("--no-mark-duplicates", action="store_true")
    al.add_argument("--base-quality-cutoff", type=int, default=25,
                    help="3' quality trim cutoff (0 disables)")
    al.add_argument("--no-clip-semialigned", action="store_true")
    al.add_argument("--no-clip-overlapping", action="store_true")
    al.add_argument("--adapter", action="append", default=None,
                    help="adapter sequence to clip (repeatable)")
    al.add_argument("--seeds", default="auto",
                    help="auto | colon-separated seed offsets, e.g. 0:32:64")
    al.add_argument("--repeat-threshold", type=int, default=10,
                    help="suppress seeds matching more reference positions")
    al.add_argument("--first-pass-seeds", type=int, default=1,
                    help="seed offsets probed before completion masking")
    al.add_argument("--dodgy-alignment-score", default="0",
                    help="Unaligned | 0-254 MAPQ for untrackable repeats")
    al.add_argument("--gap-scoring", default="bwa",
                    help="bwa | eland | m:mm:go:ge[:me] colon string")
    al.add_argument("--tls", default=None,
                    help="force template-length stats: "
                         "min:median:max:lowStdDev:highStdDev:M0:M1")
    al.add_argument("--mate-drift-range", type=int, default=-1,
                    help="rescue window = TLS median +- this (default -1: "
                         "use the min..max template range)")
    al.add_argument("--bam-pessimistic-mapq", action="store_true",
                    help="MAPQ := min(60, min(SM, AS)) for proper pairs "
                         "(manual.md:279)")
    al.add_argument("--bam-exclude-tags", default="ZX,ZY",
                    help="comma list of tags to drop from output BAMs "
                         "(all,none,AS,BC,NM,OC,RG,SM,ZX,ZY; manual.md:274)")
    al.add_argument("--memory-limit", type=float, default=0.0,
                    help="GB budget for the Build phase: genomic bins are "
                         "sized so one bin fits (reference --memory-limit)")
    al.add_argument("--records-per-bin", type=int, default=1_000_000,
                    help="genomic-bin size for the bounded-memory Build "
                         "phase (reference BinIndexMap sizing)")
    al.add_argument("--realign-gaps", default="sample",
                    choices=("no", "sample", "project", "all"),
                    help="realign reads against indels seen in other reads"
                         " (gap-sharing scope)")
    al.add_argument("--keep-unaligned", default="back",
                    choices=("discard", "front", "back"),
                    help="placement of clusters with no aligned end "
                         "(manual.md:199-206)")
    al.add_argument("--mapq-threshold", type=int, default=0,
                    help="report only templates with MAPQ >= this "
                         "(manual.md:421-424)")
    al.add_argument("--gapped-mismatches", type=int, default=5,
                    help="ungapped mismatches that trigger banded-SW "
                         "realignment (manual.md:392)")
    al.add_argument("--semialigned-gap-limit", type=int, default=100,
                    help="max long-indel length for the simple-indel "
                         "aligner; 0 disables (manual.md:520-523)")
    al.add_argument("--shadow-scan-range", type=int, default=-1,
                    help="-1: rescue over template min..max; >=0: "
                         "median +- range (manual.md:524-527)")
    al.add_argument("--realigned-gaps-per-fragment", type=int, default=4,
                    help="max known gaps combined per realignment choice")
    al.add_argument("--qscore-bin", type=int, default=0, choices=(0, 1),
                    help="bin input qualities before processing "
                         "(manual.md:459-460)")
    al.add_argument("--qscore-bin-values", default=None,
                    help="override the default quality bins, e.g. "
                         "0:0,1:1,2-9:6,... (manual.md:461-464)")
    al.add_argument("--variable-fastq-read-length", action="store_true",
                    help="accept ragged FASTQ read lengths (shorter "
                         "reads pad with N); without it they error")
    al.add_argument("--bin-regex", default="all",
                    help="all | unaligned | regex over 'contig:first-"
                         "last' bin descriptions (manual.md:317-323)")
    al.add_argument("--bam-header-tag", action="append", default=None,
                    help="extra literal BAM header line; '\\t' becomes a "
                         "tab (repeatable; manual.md:277-278)")
    al.add_argument("--bam-gzip-level", type=int, default=1,
                    help="BGZF compression level of the output BAM")
    al.add_argument("--input-parallel-load", type=int, default=2,
                    help="input parse prefetch depth (reference IO "
                         "thread knob)")
    al.add_argument("--output-parallel-save", type=int, default=2,
                    help="in-flight window of the ordered convert/"
                         "serialize stages")
    al.add_argument("--ignore-neighbors", type=int, default=0,
                    choices=(0, 1),
                    help="1: hits from neighbor-annotated k-mers count "
                         "as clean anchors anyway (manual.md:403)")
    al.add_argument("--ignore-repeats", type=int, default=0,
                    choices=(0, 1),
                    help="1: repeat-suppressed exact matches don't "
                         "block inexact seed matching (manual.md:405)")
    al.add_argument("--scatter-repeats", type=int, default=0,
                    choices=(0, 1),
                    help="1: spread exact-score-tie repeat placements "
                         "by per-read hash instead of piling them on "
                         "the first copy (manual.md:503)")
    al.add_argument("--avoid-smith-waterman", type=int, default=0,
                    choices=(0, 1),
                    help="1: skip gapped realignment of sequences with "
                         "no k-mer evidence of a gap (manual.md:272)")
    al.add_argument("--realign-dodgy", type=int, default=0,
                    choices=(0, 1),
                    help="1: also realign score-less (dodgy) reads "
                         "against known gaps (manual.md:467)")
    al.add_argument("--realign-vigorously", type=int, default=0,
                    choices=(0, 1),
                    help="1: feed realignment results back into gap "
                         "harvest and realign again (manual.md:477)")
    al.add_argument("--cleanup-intermediary", type=int, default=0,
                    choices=(0, 1),
                    help="1: erase Temp bin chunks once the Build phase "
                         "consumed them (manual.md:329)")
    al.add_argument("--memory-control", default="off",
                    choices=("off", "warning", "strict"),
                    help="behavior when the bin-budget audit trips: "
                         "strict fails the run (manual.md:429)")
    al.add_argument("--allow-empty-flowcells", type=int, default=0,
                    choices=(0, 1),
                    help="1: inputs with no reads produce a valid empty "
                         "BAM instead of failing (manual.md:271)")
    al.add_argument("--lane-number-max", type=int, default=8,
                    help="highest lane scanned when --fastq1 names a "
                         "base-calls directory of lane<N>_read1."
                         "fastq[.gz] files (manual.md:419)")
    al.add_argument("--bam-pu-format", default="%F:%L:%B",
                    help="RG PU field template: %%F flowcell, %%L lane "
                         "list, %%B barcode/sample (manual.md:281)")
    al.add_argument("-n", "--reference-name", default="default",
                    help="symbolic reference name recorded in the BAM "
                         "header (manual.md:485)")
    al.add_argument("--description", default="",
                    help="freeform text stored in the @PG DS header tag "
                         "(manual.md:366)")
    al.add_argument("--stats-image-format", default="svg",
                    choices=("svg", "gif", "none"),
                    help="none skips report plots; gif is accepted for "
                         "compatibility (plots are inline SVG; "
                         "manual.md:545)")
    al.add_argument("--expected-bgzf-ratio", type=float, default=1.0,
                    help="assumed BAM compression ratio for Build-phase "
                         "memory budgeting (manual.md:373)")
    al.add_argument("--buffer-bins", type=int, default=1, choices=(0, 1),
                    help="1: RAM write-through cache of bin chunks "
                         "(manual.md:325); 0 streams through disk only")
    al.add_argument("--pre-sort-bins", type=int, default=1,
                    choices=(0, 1),
                    help="1: position-sort each bin chunk at write time "
                         "(manual.md:457)")
    al.add_argument("--base-calls-format", default=None,
                    choices=("fastq", "fastq-gz"),
                    help="declare the input format instead of trusting "
                         "auto-detection (manual.md:298)")
    al.add_argument("--clusters-at-a-time", type=int, default=0,
                    help="force the batch size (0 = --batch-size / "
                         "--memory-limit auto; manual.md:339)")
    al.add_argument("--start-from", default=None,
                    help="rewind to this state before running")
    al.add_argument("--stop-at", default="BamDone")
    al.add_argument("--resume", action="store_true",
                    help="continue from the saved checkpoint state")
    al.set_defaults(fn=_cmd_align)

    args = p.parse_args(argv)
    if args.verbosity is not None:
        from .utils import tracing
        tracing.enable_logging(args.verbosity > 0)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
