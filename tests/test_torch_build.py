"""The port's copies of the workflow's host modules vs the JAX package's
originals, on the same numpy inputs: FASTQ streaming, BGZF, columnar
records and BAM bytes, result conversion, genomic bins, duplicate marking,
known-gap realignment, BAM writing and reading, the pipeline stages and
the error wrapper."""

import copy
import dataclasses
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from isaac_aligner_tpu import aligner as jaligner
from isaac_aligner_tpu.build import dedup as jdedup
from isaac_aligner_tpu.build import realign as jrealign
from isaac_aligner_tpu.build import records as jrecords
from isaac_aligner_tpu.build import storage as jstorage
from isaac_aligner_tpu.io import bam as jbam
from isaac_aligner_tpu.io import bgzf as jbgzf
from isaac_aligner_tpu.io import fastq as jfastq
from isaac_aligner_tpu.utils import errors as jerrors
from isaac_aligner_tpu.utils import pipeline as jpipeline
from isaac_aligner_tpu_torch.aligner import Aligner
from isaac_aligner_tpu_torch.build import dedup, realign, records, storage
from isaac_aligner_tpu_torch.io import bam, bgzf, fastq
from isaac_aligner_tpu_torch.native import build as native
from isaac_aligner_tpu_torch.utils import errors, pipeline

from test_torch_aligner import _indel_fixture
from test_torch_host import to_port_index
from test_torch_workflow import workflow_reads, write_inputs


def _batches(rows, mod):
    names = [n for n, _, _ in rows]
    b = mod.ReadBatch(names=names, bases=np.stack([r for _, r, _ in rows]),
                      quals=np.stack([q for _, _, q in rows]).astype(np.uint8),
                      lengths=np.full(len(rows), 100, np.int32))
    return mod.pad_batch(b, 128)


@pytest.fixture(scope="module")
def converted():
    """One padded 128-row batch of the workflow reads through each
    package's Aligner and its own from_single_result."""
    jidx, _ = _indel_fixture()
    _, rows = workflow_reads()
    jb, tb = _batches(rows, jfastq), _batches(rows, fastq)
    jres = jaligner.Aligner.create(jidx, read_len=100).align_batch_arrays(jb)
    tres = Aligner.create(to_port_index(jidx), read_len=100,
                          device="cpu").align_batch_arrays(tb)
    genome = jidx.genome
    jfb = jstorage.from_single_result(genome, jb, jres)
    tfb = storage.from_single_result(genome, tb, tres)
    return dict(genome=genome, jb=jb, tb=tb, jres=jres, tres=tres,
                jfb=jfb, tfb=tfb)


def _to_jax(fb) -> "jrecords.FragmentBatch":
    return jrecords.FragmentBatch(**{
        f.name: copy.deepcopy(getattr(fb, f.name))
        for f in dataclasses.fields(fb)})


def _assert_fb_equal(a, b):
    assert len(a) == len(b)
    for f in dataclasses.fields(records.FragmentBatch):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert x is not None and y is not None, f.name
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


def test_fragment_batch_fields_equal_jax():
    assert [(f.name, f.type) for f in dataclasses.fields(records.FragmentBatch)] \
        == [(f.name, f.type) for f in dataclasses.fields(jrecords.FragmentBatch)]


@pytest.mark.parametrize("res_from", ["port", "jax"])
def test_from_single_result_equals_jax(converted, res_from):
    c = converted
    got = storage.from_single_result(
        c["genome"], c["tb"], c["tres"] if res_from == "port" else c["jres"])
    _assert_fb_equal(got, c["jfb"])
    assert len(got) == 82                     # the padding rows are gone
    assert (got.flag & 4).sum() >= 4          # the all-N reads


@pytest.mark.parametrize("path", ["native", "python"])
def test_bgzf_equals_jax(converted, monkeypatch, path):
    data = records.to_bam_bytes(converted["tfb"])[0] * 40   # > 2 blocks
    if path == "python":
        monkeypatch.setattr(bgzf, "load_library", lambda name: None)
        monkeypatch.setattr(jbgzf, "load_library", lambda name: None)
    else:
        assert native.load_library("bgzf") is not None
    for level in (1, 6):
        got, blocks = bgzf.compress(data, level=level)
        want, jblocks = jbgzf.compress(data, level=level)
        assert got == want and blocks == jblocks and len(blocks) > 2
        assert bgzf.decompress(got + bgzf.EOF_BLOCK) == data
    assert bgzf.EOF_BLOCK == jbgzf.EOF_BLOCK
    assert bgzf.compress(b"") == jbgzf.compress(b"") == (b"", [])


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_to_bam_bytes_equals_jax(converted, monkeypatch, path):
    fb = converted["tfb"]
    if path == "numpy":
        for mod in (records, jrecords):
            monkeypatch.setattr(mod, "_bamrec_lib", lambda: None)
            monkeypatch.setattr(mod, "_scatter_lib", lambda: None)
    else:
        assert native.loaded() == {"bgzf": True, "bamrec": True,
                                   "scatter": True}
    fb = dataclasses.replace(fb, zx=np.arange(len(fb), dtype=np.int32),
                             rg=np.zeros(len(fb), np.int32),
                             rg_names=("s1",))
    fb.oc = np.array([None, "3M"] * (len(fb) // 2), dtype=object)
    got = records.to_bam_bytes(fb)
    want = jrecords.to_bam_bytes(_to_jax(fb))
    assert got[0] == want[0] and len(got[0]) > 0
    for x, y in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(x, y)
    excl = frozenset({"NM", "ZX", "RG", "OC"})
    a = records.apply_tag_exclusions(copy.deepcopy(fb), excl)
    b = jrecords.apply_tag_exclusions(_to_jax(fb), excl)
    assert records.to_bam_bytes(a)[0] == jrecords.to_bam_bytes(b)[0]


def test_cigar_codecs_and_spans_equal_jax(converted):
    res = converted["tres"]
    cigars = list(res["cigar"]) + ["5S10M2I3D7M4S", "100M", None, ""]
    lengths = np.full(len(cigars), 100, np.int32)
    ops, n_ops = records.cigars_to_ops(cigars, lengths)
    jops, jn = jrecords.cigars_to_ops(cigars, lengths)
    np.testing.assert_array_equal(ops, jops)
    np.testing.assert_array_equal(n_ops, jn)
    assert (n_ops > 1).any()
    for x, y in zip(records.ops_to_strings(ops, n_ops),
                    jrecords.ops_to_strings(ops, n_ops)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(records.ref_span(ops, n_ops),
                                  jrecords.ref_span(ops, n_ops))
    for x, y in zip(records.clip_spans(ops, n_ops),
                    jrecords.clip_spans(ops, n_ops)):
        np.testing.assert_array_equal(x, y)
    rng = np.random.default_rng(0)
    beg = rng.integers(0, 1 << 29, 5000)
    end = beg + rng.integers(1, 1 << 18, 5000)
    np.testing.assert_array_equal(records.reg2bin_vec(beg, end),
                                  jrecords.reg2bin_vec(beg, end))
    assert [bam.reg2bin(int(b), int(e)) for b, e in zip(beg[:200], end[:200])] \
        == [jbam.reg2bin(int(b), int(e)) for b, e in zip(beg[:200], end[:200])]


def test_save_load_concat_equal_jax(converted, tmp_path):
    fb = converted["tfb"]
    parts = [fb.take(np.arange(0, 30)), fb.take(np.arange(30, 60)),
             fb.take(np.arange(60, len(fb)))]
    parts[1].oc = np.array(["4M"] * 30, dtype=object)
    paths = []
    for i, p in enumerate(parts):
        p.save(tmp_path / f"chunk_{i}.cols")
        _to_jax(p).save(tmp_path / f"jchunk_{i}.cols")
        assert (tmp_path / f"chunk_{i}.cols").read_bytes() == \
            (tmp_path / f"jchunk_{i}.cols").read_bytes()
        paths.append(tmp_path / f"chunk_{i}.cols")
        _assert_fb_equal(records.FragmentBatch.load(paths[-1]),
                         jrecords.FragmentBatch.load(paths[-1]))
    _assert_fb_equal(records.concat(parts),
                     jrecords.concat([_to_jax(p) for p in parts]))
    _assert_fb_equal(records.concat_chunk_files(paths),
                     jrecords.concat_chunk_files(paths))


def test_sam_record_bridge_equals_jax(converted):
    fb = converted["tfb"]
    contigs = converted["genome"].contigs
    recs = records.to_sam_records(fb, contigs)
    jrecs = jrecords.to_sam_records(_to_jax(fb), contigs)
    assert [r.to_line() for r in recs] == [r.to_line() for r in jrecs]
    rows = np.array([1, 5, 9])
    for r in recs:
        r.flag |= 0x400
    for r in jrecs:
        r.flag |= 0x400
    recs[1].cigar = jrecs[1].cigar = "50M2D48M2S"
    a, b = copy.deepcopy(fb), _to_jax(fb)
    records.update_from_sam_records(a, rows, [recs[i] for i in rows], contigs)
    jrecords.update_from_sam_records(b, rows, [jrecs[i] for i in rows],
                                     contigs)
    _assert_fb_equal(a, b)


def _tree(d: Path) -> dict:
    return {p.relative_to(d).as_posix(): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("sample_cap", [40, 1000], ids=["sampled", "buffered"])
def test_distribution_bin_store_equals_jax(converted, tmp_path, sample_cap):
    fb = converted["tfb"]
    offs = converted["genome"].contig_offsets
    glen = converted["genome"].total_length
    stores = [mod.DistributionBinStore(tmp_path / name, offs, glen, 3,
                                       sample_cap=sample_cap, pre_sort=True)
              for mod, name in ((storage, "port"), (jstorage, "jax"))]
    for s in stores:
        for i, lo in enumerate(range(0, len(fb), 30)):
            part = fb.take(np.arange(lo, min(lo + 30, len(fb))))
            s.add(part if s is stores[0] else _to_jax(part), seq=i)
        s.finalize()
    port, jax_ = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert port == jax_
    assert "boundaries.json" in port
    assert sum(k.startswith("bin_") for k in port) > 1
    assert any(k.startswith("unaligned/") for k in port)
    assert stores[0].records == stores[1].records == len(fb)
    for d in sorted((tmp_path / "port").glob("bin_*")):
        _assert_fb_equal(storage.BinnedFragmentStore.load_bin(d),
                         jstorage.BinnedFragmentStore.load_bin(
                             tmp_path / "jax" / d.name))
    ids = storage.record_bin_ids(fb, offs, 7000, 3)
    np.testing.assert_array_equal(
        ids, jstorage.record_bin_ids(_to_jax(fb), offs, 7000, 3))


def _sorted_marked(converted, mod, fb, keep=True):
    fb = fb.take(mod.coordinate_sort_order(fb))
    return mod.mark_duplicates_batch(fb, converted["genome"].contig_offsets,
                                     keep=keep)


@pytest.mark.parametrize("keep", [True, False], ids=["mark", "remove"])
def test_dedup_equals_jax(converted, keep):
    fb = converted["tfb"]
    order = dedup.coordinate_sort_order(fb)
    np.testing.assert_array_equal(order,
                                  jdedup.coordinate_sort_order(_to_jax(fb)))
    got = _sorted_marked(converted, dedup, copy.deepcopy(fb), keep)
    want = _sorted_marked(converted, jdedup, _to_jax(fb), keep)
    _assert_fb_equal(got, want)
    n_dup = int(((copy.deepcopy(fb).flag & 0x400) == 0).sum())
    if keep:
        assert int((got.flag & 0x400).astype(bool).sum()) == 8
    else:
        assert len(got) == n_dup - 8


def test_realign_batch_equals_jax(converted):
    fb = _sorted_marked(converted, dedup,
                        copy.deepcopy(converted["tfb"]))
    jfb = _to_jax(fb)
    genome = converted["genome"]
    got = realign.realign_batch(fb, genome, realign_dodgy=False)
    want = jrealign.realign_batch(jfb, genome, realign_dodgy=False)
    assert got == want >= 3
    _assert_fb_equal(fb, jfb)
    assert any(o and "D" not in o for o in fb.oc if o)


def test_bam_writer_and_reader_equal_jax(converted, tmp_path):
    fb = _sorted_marked(converted, dedup,
                        copy.deepcopy(converted["tfb"]))
    contigs = converted["genome"].contigs
    kw = dict(sample="s1", pu="unknown:all:s1", description="d",
              reference_name="ref", extra_tags=("@CO\tx",))
    for mod, name, batch in ((bam, "port", fb), (jbam, "jax", _to_jax(fb))):
        with mod.BamWriter(tmp_path / f"{name}.bam", contigs, **kw) as w:
            w.write_fragment_batch(batch.take(np.arange(0, 40)))
            w.write_fragment_batch(batch.take(np.arange(40, len(batch))))
    for ext in ("", ".bai"):
        assert (tmp_path / f"port.bam{ext}").read_bytes() == \
            (tmp_path / f"jax.bam{ext}").read_bytes(), ext
    assert (tmp_path / "port.bam.md5").read_text().split()[0] == \
        (tmp_path / "jax.bam.md5").read_text().split()[0]
    text, refs, recs = bam.read_bam(tmp_path / "port.bam")
    jtext, jrefs, jrecs = jbam.read_bam(tmp_path / "port.bam")
    assert (text, refs) == (jtext, jrefs)
    assert [r.to_line() for r in recs] == [r.to_line() for r in jrecs]
    assert len(recs) == len(fb)
    # the record-list path of the writer too
    bam.write_bam(tmp_path / "rec.bam", recs[:20], contigs)
    jbam.write_bam(tmp_path / "jrec.bam", jrecs[:20], contigs)
    assert (tmp_path / "rec.bam").read_bytes() == \
        (tmp_path / "jrec.bam").read_bytes()
    assert bam.header_bytes(contigs) == jbam.header_bytes(contigs)


@pytest.mark.parametrize("window", [1, 3])
def test_pipeline_stages_equal_jax(window):
    rng = np.random.default_rng(window)
    delays = rng.random(40) * 2e-3
    outs = []
    for mod in (pipeline, jpipeline):
        seen, threads = [], set()

        def work(i, x):
            time.sleep(delays[i])
            threads.add(threading.get_ident())
            seen.append((i, x))
        stage = mod.OrderedStage(work, window=window)
        for i, x in enumerate(mod.prefetch_iter(iter(range(100, 140)),
                                                depth=window)):
            stage.submit(i, x)
        stage.close()
        outs.append(seen)
        assert len(threads) == 1
    assert outs[0] == outs[1] == list(enumerate(range(100, 140)))

    def bad():
        yield 1
        raise ValueError("parse error")
    for mod in (pipeline, jpipeline):
        with pytest.raises(ValueError, match="parse error"):
            list(mod.prefetch_iter(bad()))


def test_fastq_streaming_equals_jax(tmp_path):
    d = write_inputs(tmp_path)
    path = d / "r1.fq"
    for bs in (32, 128):
        got = list(fastq.iter_fastq_batches(path, None, bs))
        want = list(jfastq.iter_fastq_batches(path, None, bs))
        assert len(got) == len(want) == -(-82 // bs)
        for (b, b2, bc), (jb, jb2, jbc) in zip(got, want):
            assert b2 is bc is jb2 is jbc is None
            assert list(b.names) == list(jb.names)
            assert b.n_valid == jb.n_valid
            for name in ("bases", "quals", "lengths"):
                np.testing.assert_array_equal(getattr(b, name),
                                              getattr(jb, name))
    assert fastq.estimate_fastq_reads(path) == \
        jfastq.estimate_fastq_reads(path) == 82
    assert list(fastq.iter_fastq_records_bulk(path, chunk_bytes=4096)) == \
        list(jfastq.iter_fastq_records_bulk(path, chunk_bytes=4096))
    # paired streaming: read 2 rides beside read 1, each at its own width
    (d / "r2.fq").write_text("".join(
        f"@{i}\n{'ACGT' * 20}\n+\n{'I' * 80}\n" for i in range(82)))
    got = list(fastq.iter_fastq_batches(path, d / "r2.fq", 32))
    want = list(jfastq.iter_fastq_batches(path, d / "r2.fq", 32))
    assert len(got) == len(want) == 3
    for (b, b2, bc), (jb, jb2, jbc) in zip(got, want):
        assert bc is jbc is None and b2.read_len == 80
        for x, y in ((b, jb), (b2, jb2)):
            assert list(x.names) == list(y.names) and x.n_valid == y.n_valid
            for name in ("bases", "quals", "lengths"):
                np.testing.assert_array_equal(getattr(x, name),
                                              getattr(y, name))
    # a barcode FASTQ (here read 1 itself) rides beside the batches
    got = list(fastq.iter_fastq_batches(path, None, 32, barcode_path=path))
    want = list(jfastq.iter_fastq_batches(path, None, 32, barcode_path=path))
    assert len(got) == len(want) == 3
    for (b, _b2, bc), (_jb, _jb2, jbc) in zip(got, want):
        np.testing.assert_array_equal(bc, jbc)
        np.testing.assert_array_equal(bc, b.bases[:b.n_valid])
    names = ["a", "bb", "ccc"]
    for ln, jln in ((fastq.LazyNames.from_list(names),
                     jfastq.LazyNames.from_list(names)),):
        p, jp = ln.with_padding(6), jln.with_padding(6)
        assert list(p) == list(jp) and p.pad_from == jp.pad_from == 3
        for x, y in zip(p.matrix(np.arange(6)), jp.matrix(np.arange(6))):
            np.testing.assert_array_equal(x, y)
        assert list(p[1:5]) == list(jp[1:5])


def test_errors_run_equals_jax(capsys):
    for mod in (errors, jerrors):
        def fail(kind):
            def main(argv):
                raise kind("bad")
            return main
        assert mod.run(fail(mod.InvalidOptionError)) == 3
        assert mod.run(fail(mod.MemoryError_)) == 5
        assert mod.run(fail(ValueError)) == 2
        assert mod.run(lambda argv: 0) == 0
    err = capsys.readouterr().err
    assert err.count("InvalidOptionError: bad") == 2
