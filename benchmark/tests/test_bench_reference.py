"""The plain reference: the judge's verdicts on planted alignments, and
the BAM, BAI and MD5 reader on a BAM the program writes."""

import numpy as np
import pytest

import generator
from reference import bamfile
from reference.judge import Judge, kmer_codes, revcomp, revcomp_codes

RNG = np.random.default_rng(5)
CODES = RNG.integers(0, 4, 20_000).astype(np.uint8)
CODES[15_000:15_200] = 4
REPEAT = CODES[2_000:2_300].copy()
CODES[9_000:9_300] = REPEAT             # an exact second copy


def judge():
    return Judge(CODES, [0, 12_000], [12_000, 20_000], 32, 10)


def read_at(start, reverse=False, l=150):
    fwd = CODES[start:start + l].copy()
    return revcomp(fwd) if reverse else fwd


def test_kmer_codes_and_counts():
    k = kmer_codes(np.array([0, 1, 2, 3, 0], np.uint8), 4)
    assert k.tolist() == [0b00011011, 0b01101100]
    assert revcomp_codes(k, 4)[0] == 0b00011011      # ACGT is its own rc
    j = judge()
    assert j.counts.count(kmer_codes(REPEAT[:32], 32)).tolist() == [2]


@pytest.mark.parametrize("reverse", [False, True])
def test_at_truth_is_placed(reverse):
    j = judge()
    seq = read_at(500, reverse)
    truth = (500, reverse, 0, 0)
    place = bool(j.seedable(seq[None], tuple(np.array([x]) for x in truth))[0])
    assert place
    assert j.end(seq, truth, place, True, 500, reverse, "150M", 0) == (
        True, False, False)
    # soft clips cost nothing
    assert j.end(seq, truth, place, True, 510, reverse, "10S140M", 0)[1:] \
        == (False, False)


def test_shifted_or_missing_is_misplaced():
    j = judge()
    seq = read_at(500)
    truth = (500, False, 0, 0)
    nm = int((seq != CODES[501:651]).sum())
    assert j.end(seq, truth, True, True, 501, False, "150M", nm) == (
        True, True, False)
    assert j.end(seq, truth, True, False, -1, False, None, 0) == (
        True, True, False)


def test_equal_repeat_copy_is_not_misplaced():
    j = judge()
    seq = read_at(2_050)
    truth = (2_050, False, 0, 0)
    # the same 150 bases at the second copy
    assert j.end(seq, truth, True, True, 9_050, False, "150M", 0) == (
        True, False, False)


def test_nm_and_cigar_checked_exactly():
    j = judge()
    seq = read_at(500).copy()
    seq[70] = (seq[70] + 1) % 4
    truth = (500, False, 0, 0)
    assert j.end(seq, truth, True, True, 500, False, "150M", 1)[2] is False
    assert j.end(seq, truth, True, True, 500, False, "150M", 0)[2] is True
    # a CIGAR that does not cover the read, or leaves the contig
    assert j.end(seq, truth, True, True, 500, False, "140M", 1)[2] is True
    assert j.end(seq, truth, True, True, 11_900, False, "150M", 1)[2] is True


def test_indel_truth():
    j = judge()
    l, at, k = 150, 60, 3
    fwd = np.concatenate([CODES[500:500 + at], CODES[500 + at + k:500 + l + k]])
    truth = (500, False, -k, at)
    assert j.end(fwd, truth, True, True, 500, False, f"{at}M{k}D{l - at}M",
                 k) == (True, False, False)
    # the deletion clipped away, still at the truth
    assert j.end(fwd, truth, True, True, 500, False, f"{at}M{l - at}S",
                 0)[1:] == (False, False)


def test_unplaceable_reads():
    j = judge()
    starts = np.array([14_950, 11_900, 500, 2_050, 500])
    seqs = np.stack([read_at(s) for s in starts])
    seqs[4, 40:] = read_at(500 + 40 + 3)[:110]      # a 3 bp deletion at 40
    got = j.seedable(seqs, (starts, np.zeros(5, bool),
                            np.array([0, 0, 0, 0, -3]),
                            np.array([0, 0, 0, 0, 40])))
    # into the N block; across two contigs; placeable; a two-copy
    # repeat (within the threshold); placeable through its deletion
    assert got.tolist() == [False, False, True, True, True]


def test_damaged_mate_placeable_through_its_read1():
    import types
    j = judge()
    damaged = read_at(700).copy()
    damaged[::10] = (damaged[::10] + 1) % 4
    lib = types.SimpleNamespace(
        bases=np.stack([read_at(500), damaged])[:, None, :], read_len=150,
        start=np.array([[500], [700]]), reverse=np.zeros((2, 1), bool),
        indel=np.zeros((2, 1), np.int64), indel_at=np.zeros((2, 1), np.int64),
        damaged=np.array([True]))
    assert j.placeable(lib, np.array([0]))[:, 0].tolist() == [True, True]
    lib.damaged = np.array([False])
    assert j.placeable(lib, np.array([0]))[:, 0].tolist() == [True, False]


def test_bam_reader_on_a_bam_the_program_writes(tmp_path):
    """A workflow run of the program on the CPU: every record, tag, the
    .bai and the .md5 read back by the plain reader."""
    import program
    spec = {"seed": 3, "contigs": [{"name": "c1", "length": 120_000},
                                    {"name": "c2", "length": 80_000}]}
    g = generator.make_genome(spec)
    lib = generator.make_library(g, {
        "read_len": 150, "insert": [350, 60], "insert_range": [200, 600],
        "mutate": 0.01, "indel_frac": 0.03, "max_indel": 8, "margin": 20,
        "damaged_frac": 0.0, "far_frac": 0.0, "far_min": 50_000,
        "dup_frac": 0.0, "quals": {"levels": [37, 23, 12, 2],
                                   "best": [0.92, 0.55], "rest": [6, 3, 1]}},
        1024, 11)
    from isaac_aligner_tpu_torch.index.build import build_index
    build_index(program.port_genome(g), seed_len=32, device="cpu").save(
        tmp_path / "idx")
    fq = [tmp_path / "r1.fq.gz", tmp_path / "r2.fq.gz"]
    for e in (0, 1):
        generator.write_fastq_gz(fq[e], lib.bases[e], lib.quals[e])
    program.run_workflow(tmp_path / "idx", fq[0], fq[1], tmp_path / "out",
                         "cpu", {"clip_overlapping": False})
    bam = bamfile.Bam(tmp_path / "out" / "sorted.bam")
    assert [r[0] for r in bam.refs] == ["c1", "c2"]
    assert len(bam) == 2 * 1024
    assert bam.order_errors() == 0 and bam.md5_errors() == 0
    assert bamfile.bai_errors(bam, np.random.default_rng(0)) == 0
    names = bam.names()
    assert sorted(set(names)) == sorted(f"t{i}" for i in range(1024))
    i = int(np.nonzero(~(bam.flag & 4).astype(bool))[0][0])
    t, e = int(names[i][1:]), 0 if bam.flag[i] & 0x40 else 1
    s, q = bam.seq_qual(i)
    if bam.flag[i] & 0x10:
        s, q = revcomp(s), q[::-1]
    assert (s == lib.bases[e, t]).all() and (q == lib.quals[e, t]).all()
    assert bam.int_tag(i, "NM") is not None
    # a .md5 that is not the file's digest, and a missing .bai, are seen
    (tmp_path / "copy.bam").write_bytes(bam.raw)
    (tmp_path / "copy.bam.md5").write_text("0" * 32 + "\n")
    copy = bamfile.Bam(tmp_path / "copy.bam")
    assert copy.md5_errors() == 1
    assert bamfile.bai_errors(copy, np.random.default_rng(0), 5) == 5
