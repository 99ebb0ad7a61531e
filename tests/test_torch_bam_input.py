"""BAM input in the port vs the JAX package, on the CPU.

The port's copy of `io/bam_input.py` against the original: BGZF chunking,
the streamed records, `iter_bam_batches` with one BGZF member a chunk (so
mates meet through the cross-chunk pair cache) and `reads_from_bam`, all
on a coordinate-sorted BAM whose reads are known; `from_sam_records`
against the JAX copy; and the --bam workflow (single-end and paired
realignment of a sorted BAM) with sorted.bam, .bai, .md5 and the Stats
JSON equal to the JAX workflow's.
"""

import dataclasses
import functools
from pathlib import Path

import numpy as np
import pytest

from isaac_aligner_tpu.build import storage as jstorage
from isaac_aligner_tpu.io import bam_input as jbam_input
from isaac_aligner_tpu.workflow import align as jwf
from isaac_aligner_tpu_torch import dna, synthetic
from isaac_aligner_tpu_torch.build import storage
from isaac_aligner_tpu_torch.io import bam_input, sam
from isaac_aligner_tpu_torch.io.bam import read_bam, write_bam
from isaac_aligner_tpu_torch.workflow import align as wf

from test_torch_bcl import assert_outputs_equal
from test_torch_paired import pair_genome, write_pair_inputs

BATCH = 64


def _revcomp(codes):
    return dna.revcomp(np.asarray(codes, np.uint8))


def write_known_bam(path: Path, n_pairs: int = 1000, seed: int = 9):
    """A coordinate-sorted paired BAM on pair_genome's chrA whose reads
    are known: FR pairs (read 2 stored reverse-complemented, as an aligner
    writes it), a secondary and a supplementary copy of some records (the
    readers skip them), two orphans (dropped) and a few '*' qualities.
    Returns (contigs, {name: (read1 codes, read2 codes)})."""
    rng = np.random.default_rng(seed)
    genome = pair_genome()
    sp = synthetic.make_pairs(rng, genome.codes[:16_000], n_pairs,
                              far_frac=0.0, indel_frac=0.0, damaged_frac=0.0)
    recs, truth = [], {}
    for i in range(n_pairs):
        name = f"t{i:05d}"
        truth[name] = (sp.bases1[i], sp.bases2[i])
        for end, bases, start, rev in (
                (1, sp.bases1[i], sp.start1[i], sp.reverse1[i]),
                (2, sp.bases2[i], sp.start2[i], sp.reverse2[i])):
            stored = _revcomp(bases) if rev else bases
            qual = "".join(chr(33 + int(q)) for q in rng.integers(2, 41, 100))
            if i % 97 == 5:
                qual = "*"
            flag = (sam.FLAG_PAIRED | sam.FLAG_PROPER_PAIR
                    | (sam.FLAG_REVERSE if rev else 0)
                    | (sam.FLAG_READ1 if end == 1 else sam.FLAG_READ2))
            recs.append(sam.SamRecord(
                qname=name, flag=flag, rname="chrA", pos=int(start) + 1,
                mapq=60, cigar="100M", rnext="=", seq=dna.decode(stored),
                qual=qual))
            if i % 50 == 3:
                extra = dataclasses.replace(
                    recs[-1], flag=flag | (sam.FLAG_SECONDARY if end == 1
                                           else sam.FLAG_SUPPLEMENTARY))
                recs.append(extra)
    for j in range(2):
        recs.append(sam.SamRecord(
            qname=f"orphan{j}", flag=sam.FLAG_PAIRED | sam.FLAG_READ1,
            rname="chrA", pos=500 + j, mapq=60, cigar="100M",
            seq=dna.decode(genome.codes[499 + j:599 + j]), qual="I" * 100))
    recs.sort(key=lambda r: r.pos)
    write_bam(path, recs, genome.contigs)
    return genome.contigs, truth


@pytest.fixture(scope="module")
def known_bam(tmp_path_factory):
    path = tmp_path_factory.mktemp("bam_known") / "known.bam"
    contigs, truth = write_known_bam(path)
    return path, contigs, truth


def _small_chunks(monkeypatch, members: int):
    for mod in (bam_input, jbam_input):
        monkeypatch.setattr(mod, "_iter_bgzf_decompressed", functools.partial(
            mod._iter_bgzf_decompressed, members_per_chunk=members))


@pytest.mark.parametrize("members", [1, 3, 512])
def test_bgzf_chunks_equal_jax(known_bam, members):
    path = known_bam[0]
    got = list(bam_input._iter_bgzf_decompressed(path, members))
    want = list(jbam_input._iter_bgzf_decompressed(path, members))
    assert got == want
    if members == 1:
        assert len(got) > 5


def test_streamed_records_equal_jax(known_bam):
    got = list(bam_input._iter_bam_records_streaming(known_bam[0]))
    want = list(jbam_input._iter_bam_records_streaming(known_bam[0]))
    assert len(got) == len(want) == 2002
    for a, b in zip(got, want):
        assert a[:2] == b[:2]
        np.testing.assert_array_equal(a[2], b[2])
        np.testing.assert_array_equal(a[3], b[3])


@pytest.mark.parametrize("members", [1, 512])
@pytest.mark.parametrize("batch", [100, 1024])
def test_iter_bam_batches_equal_jax_across_chunks(known_bam, monkeypatch,
                                                  members, batch):
    """One BGZF member a chunk puts mates in different chunks; the pair
    cache matches them, and each end comes back in its sequenced
    orientation."""
    path, _contigs, truth = known_bam
    _small_chunks(monkeypatch, members)
    got = list(bam_input.iter_bam_batches(path, batch))
    want = list(jbam_input.iter_bam_batches(path, batch))
    assert len(got) == len(want) == -(-len(truth) // batch)
    seen = 0
    for (g1, g2, gbc), (w1, w2, wbc) in zip(got, want):
        assert gbc is None and wbc is None
        for a, b in ((g1, w1), (g2, w2)):
            assert list(a.names) == list(b.names)
            for f in ("bases", "quals", "lengths"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        for i in range(g1.n_valid):
            r1, r2 = truth[g1.names[i]]
            np.testing.assert_array_equal(g1.bases[i], r1)
            np.testing.assert_array_equal(g2.bases[i], r2)
            seen += 1
    assert seen == len(truth)


def test_reads_from_bam_equals_jax(known_bam):
    path, _contigs, truth = known_bam
    got, want = bam_input.reads_from_bam(path), jbam_input.reads_from_bam(path)
    for a, b in zip(got, want):
        assert list(a.names) == list(b.names)
        for f in ("bases", "quals", "lengths"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert sorted(got[0].names) == sorted(truth)


def _fb_columns(fb):
    return {f.name: getattr(fb, f.name) for f in dataclasses.fields(fb)}


@pytest.mark.parametrize("source", ["known", "workflow"])
def test_from_sam_records_equals_jax(known_bam, ran, source):
    if source == "known":
        path, contigs = known_bam[0], known_bam[1]
    else:
        path = ran("bam_paired")[1] / "sorted.bam"
        contigs = pair_genome().contigs
    recs = read_bam(path)[2]
    rg = ("sample", "other")
    got = storage.from_sam_records(recs, contigs, rg_names=rg)
    want = jstorage.from_sam_records(recs, contigs, rg_names=rg)
    a, b = _fb_columns(got), _fb_columns(want)
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k
    if source == "workflow":
        assert (got.nm >= 0).any() and (got.n_mc > 0).any()


# -- the --bam workflow -----------------------------------------------------


@pytest.fixture(scope="module")
def inputs(tmp_path_factory) -> Path:
    """ref.fa and the paired fixture's FASTQs, realigned by the port into
    sorted BAMs: se.bam (read 1 only) and pe.bam (pairs), coordinate
    sorted, so mates lie apart."""
    d = write_pair_inputs(tmp_path_factory.mktemp("bam_in"))
    for name, kw in (("se", {}), ("pe", {"fastq2": str(d / "r2.fq")})):
        out = d / f"{name}_out"
        wf.AlignWorkflow(wf.WorkflowOptions(
            reference=str(d / "ref.fa"), output_dir=str(out),
            fastq1=str(d / "r1.fq"), batch_size=BATCH, device="cpu",
            **kw)).run()
        (out / "sorted.bam").rename(d / f"{name}.bam")
    return d


CASES = {"bam_single": "se.bam", "bam_paired": "pe.bam"}


@pytest.fixture(scope="module")
def ran(inputs, tmp_path_factory):
    """case -> (JAX output dir, port output dir), each run once."""
    done: dict = {}

    def get(case: str):
        if case not in done:
            outs = []
            for mod in (jwf, wf):
                out = tmp_path_factory.mktemp(f"{case}_{mod.__name__[:18]}")
                kw = dict(reference=str(inputs / "ref.fa"),
                          output_dir=str(out), batch_size=BATCH,
                          bam_input=str(inputs / CASES[case]))
                if mod is wf:
                    kw["device"] = "cpu"
                mod.AlignWorkflow(mod.WorkflowOptions(**kw)).run()
                outs.append(out)
            done[case] = tuple(outs)
        return done[case]
    return get


@pytest.mark.parametrize("case", list(CASES))
def test_bam_workflow_equals_jax(case, inputs, ran):
    jout, tout = ran(case)
    assert_outputs_equal(jout, tout)
    src = read_bam(inputs / CASES[case])[2]
    out = read_bam(tout / "sorted.bam")[2]
    assert len(out) == len(src)
    # read 1 / read 2 identities survive the round trip
    ends = {(r.qname, r.flag & 0xC0) for r in src}
    assert {(r.qname, r.flag & 0xC0) for r in out} == ends
    if case == "bam_paired":
        assert sum(bool(r.flag & sam.FLAG_PROPER_PAIR) for r in out) > \
            0.7 * len(out)


def test_bam_input_is_paired_as_its_records(inputs, tmp_path):
    for name, paired in (("se.bam", False), ("pe.bam", True)):
        run = wf.AlignWorkflow(wf.WorkflowOptions(
            reference=str(inputs / "ref.fa"), output_dir=str(tmp_path / name),
            bam_input=str(inputs / name), device="cpu"))
        assert run._paired is paired
        assert run._estimate_total_reads() == \
            len(read_bam(inputs / name)[2]) // (2 if paired else 1)
