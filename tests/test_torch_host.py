"""The port's own host modules vs the JAX package's, on the same inputs.

The port keeps copies of the JAX package's jax-free host modules (dna,
io.fasta/fastq/sam/bam/bcl/use_bases_mask/bam_input, demultiplexing,
build.storage, index.build, align.clippers, utils.tracing, workflow
per_barcode/stats_agg) so that it imports nothing of `isaac_aligner_tpu`.
These tests hold each copy to its original (the input and demultiplexing
modules in detail in test_torch_bcl/bam_input/demux.py), check that index
directories cross between the two packages, that the output process's
modules import no torch, and parse every file of the port for stray
imports.
"""

import ast
import copy
import dataclasses
import gzip
from pathlib import Path

import numpy as np
import pytest

from __graft_entry__ import _tiny_fixture
from isaac_aligner_tpu import aligner as jaligner
from isaac_aligner_tpu import dna as jdna
from isaac_aligner_tpu.align import clippers as jclippers
from isaac_aligner_tpu.index import build as jbuild
from isaac_aligner_tpu.io import bam as jbam
from isaac_aligner_tpu.io import fastq as jfastq
from isaac_aligner_tpu.io import sam as jsam
from isaac_aligner_tpu.utils import tracing as jtracing
from isaac_aligner_tpu_torch import dna
from isaac_aligner_tpu_torch import synthetic
from isaac_aligner_tpu_torch.align import clippers
from isaac_aligner_tpu_torch.aligner import Aligner
from isaac_aligner_tpu_torch.index import build
from isaac_aligner_tpu_torch.io import bam, fasta, fastq, sam
from isaac_aligner_tpu_torch.utils import tracing

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted(p.relative_to(REPO).as_posix()
                    for p in (REPO / "isaac_aligner_tpu_torch").rglob("*.py"))


def to_port_index(jidx) -> build.SeedIndex:
    """Carry a JAX-built SeedIndex across into the port's type."""
    return build.SeedIndex.from_arrays(
        seed_len=jidx.seed_len, repeat_threshold=jidx.repeat_threshold,
        genome_codes=jidx.genome.codes,
        contigs=[dataclasses.asdict(c) for c in jidx.genome.contigs],
        key_hi=jidx.key_hi, key_lo=jidx.key_lo, pos=jidx.pos,
        total_kmers=jidx.total_kmers, collapsed_kmers=jidx.collapsed_kmers,
        has_neighbors=jidx.has_neighbors, key_mids=jidx.key_mids)


def _forbidden_imports(path: Path) -> list[str]:
    """Imports of jax* or of isaac_aligner_tpu (not _torch) in a file."""
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top == "isaac_aligner_tpu" or top.startswith("jax"):
                bad.append(f"{path.name}:{node.lineno} imports {name}")
    return bad


@pytest.mark.parametrize("rel", PORT_FILES + ["chip_smoke.py"])
def test_port_file_imports_no_jax_package(rel):
    assert _forbidden_imports(REPO / rel) == []


#: host modules the port copied from the JAX package, under the same names
HOST_COPIES = ["dna", "io.fastq", "io.bam", "io.bcl",
               "io.use_bases_mask", "io.bam_input", "demultiplexing",
               "demultiplexing.samplesheet", "demultiplexing.resolver",
               "build.storage", "workflow.stats_agg", "workflow.per_barcode"]


@pytest.mark.parametrize("name", HOST_COPIES)
def test_host_copy_has_the_jax_api(name):
    """Every public function and class of the JAX module is in the port's
    copy with the same signature (the port may add its own)."""
    import importlib
    import inspect

    jmod = importlib.import_module(f"isaac_aligner_tpu.{name}")
    mod = importlib.import_module(f"isaac_aligner_tpu_torch.{name}")
    for attr, obj in vars(jmod).items():
        if attr.startswith("__") or not (inspect.isfunction(obj)
                                         or inspect.isclass(obj)):
            continue
        if getattr(obj, "__module__", "").split(".")[0] != "isaac_aligner_tpu":
            continue
        mine = getattr(mod, attr, None)
        assert mine is not None, f"{name}.{attr} missing"
        if inspect.isfunction(obj):
            assert inspect.signature(mine) == inspect.signature(obj), attr


def test_output_process_modules_import_no_torch():
    """What the spawned output process imports to resolve barcodes and
    parse run-folder names pulls in no torch."""
    import subprocess
    import sys

    code = ("import sys\n"
            "import isaac_aligner_tpu_torch.workflow.output_proc\n"
            "import isaac_aligner_tpu_torch.demultiplexing.resolver\n"
            "import isaac_aligner_tpu_torch.demultiplexing.samplesheet\n"
            "import isaac_aligner_tpu_torch.dna\n"
            "import isaac_aligner_tpu_torch.io.bcl\n"
            "import isaac_aligner_tpu_torch.build.storage\n"
            "assert 'torch' not in sys.modules\n"
            "print('OK')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr


def test_import_scan_catches_the_jax_package(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jaxlib\nfrom isaac_aligner_tpu.io import sam\n"
                 "import isaac_aligner_tpu_torch\nfrom . import dna\n")
    assert len(_forbidden_imports(f)) == 2


def _repeat_genome():
    rng = np.random.default_rng(5)
    return synthetic.make_genome(rng, 12_000, families=((200, 40, 0.0),),
                                 n_island=(9_000, 100), n_contigs=2)


@pytest.mark.parametrize("which,seed_len,threshold",
                         [("tiny", 32, 1000), ("tiny", 16, 1000),
                          ("repeats", 32, 20)])
def test_build_index_equals_jax(which, seed_len, threshold):
    if which == "tiny":
        jgenome = _tiny_fixture()[0].genome
        genome = fasta.Genome(
            codes=jgenome.codes.copy(),
            contigs=[fasta.ContigMeta(**dataclasses.asdict(c))
                     for c in jgenome.contigs])
    else:
        genome = _repeat_genome()
    want = jbuild.build_index(genome, seed_len=seed_len,
                              repeat_threshold=threshold)
    got = build.build_index(genome, seed_len=seed_len,
                            repeat_threshold=threshold)
    for name in ("key_hi", "key_lo", "pos"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("seed_len", "repeat_threshold", "total_kmers",
                 "collapsed_kmers", "num_records"):
        assert getattr(got, name) == getattr(want, name), name
    if which == "repeats":
        assert got.collapsed_kmers > 0
    carried = to_port_index(want)
    np.testing.assert_array_equal(carried.key_hi, got.key_hi)
    assert [dataclasses.asdict(c) for c in carried.genome.contigs] == \
        [dataclasses.asdict(c) for c in got.genome.contigs]


def test_index_saved_by_jax_aligns_identically_in_port(tmp_path):
    from test_torch_aligner import _indel_fixture

    jidx, batch = _indel_fixture()
    jidx.save(tmp_path / "jax_idx")
    index = build.SeedIndex.load(tmp_path / "jax_idx")
    assert isinstance(index, build.SeedIndex)
    assert index._bucket_table[1:] == jbuild.SeedIndex.load(
        tmp_path / "jax_idx")._bucket_table[1:]
    want = jaligner.Aligner.create(jidx, read_len=100).align_to_sam(batch)
    got = Aligner.create(index, read_len=100,
                         device="cpu").align_to_sam(batch)
    assert [r.to_line() for r in got] == [r.to_line() for r in want]
    # and back: the port's save loads in the JAX package, same files
    index.save(tmp_path / "port_idx")
    back = jbuild.SeedIndex.load(tmp_path / "port_idx")
    for name in ("key_hi", "key_lo", "pos"):
        np.testing.assert_array_equal(getattr(back, name),
                                      getattr(jidx, name))
    for f in sorted((tmp_path / "jax_idx").iterdir()):
        assert f.read_bytes() == (tmp_path / "port_idx" / f.name).read_bytes(), \
            f.name


_FASTQ = (b"@r0 extra words\nACGTNacgtn\n+\nIIIII#####\n"
          b"@r1\nTTTTGGGG\n+r1\n!!!!IIII\n\n"
          b"@r2\tdesc\nNNRYacgt\n+\nABCDEFGH\n")


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gzip"])
def test_read_fastq_equals_jax(tmp_path, gz):
    path = tmp_path / ("r.fq.gz" if gz else "r.fq")
    path.write_bytes(gzip.compress(_FASTQ) if gz else _FASTQ)
    want = jfastq.read_fastq(path)
    got = fastq.read_fastq(path)
    assert list(got.names) == list(want.names) == ["r0", "r1", "r2"]
    for name in ("bases", "quals", "lengths"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (got.count, got.read_len) == (want.count, want.read_len)


def test_read_fastq_rejects_what_jax_rejects(tmp_path):
    for bad in (b"@r0\nACGT\n-\nIIII\n", b"@r0\nACGT\n+\nIII\n",
                b"r0\nACGT\n+\nIIII\n"):
        path = tmp_path / "bad.fq"
        path.write_bytes(bad)
        with pytest.raises(ValueError) as want:
            jfastq.read_fastq(path)
        with pytest.raises(ValueError) as got:
            fastq.read_fastq(path)
        assert str(got.value) == str(want.value)


def test_batch_from_reads_equals_jax():
    seqs = ["ACGTACGT", "acgN", "TTTTTTTTTTTT"]
    for quals in (None, ["IIIIIIII", "!!!!", "ABCDEFGHIJKL"]):
        want = jfastq.batch_from_reads(["a", "b", "c"], seqs, quals)
        got = fastq.batch_from_reads(["a", "b", "c"], seqs, quals)
        for name in ("bases", "quals", "lengths"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name))


def _port_records():
    from test_torch_aligner import _indel_fixture

    jidx, batch = _indel_fixture()
    index = to_port_index(jidx)
    return index, batch, Aligner.create(index, read_len=100,
                                        device="cpu").align_to_sam(batch)


def test_write_sam_bytes_equal_jax(tmp_path):
    index, _batch, recs = _port_records()
    jrecs = [jsam.SamRecord(**dataclasses.asdict(r)) for r in recs]
    kw = dict(sample="s1", description="d", reference_name="ref",
              extra_tags=("@CO\tx",), pu="fc.1")
    sam.write_sam(tmp_path / "port.sam", recs, index.genome.contigs, **kw)
    jsam.write_sam(tmp_path / "jax.sam", jrecs, index.genome.contigs, **kw)
    assert (tmp_path / "port.sam").read_bytes() == \
        (tmp_path / "jax.sam").read_bytes()
    assert sam.header_lines(index.genome.contigs) == \
        jsam.header_lines(index.genome.contigs)
    assert [r.is_mapped for r in recs] == [r.is_mapped for r in jrecs]
    flags = {k: v for k, v in vars(sam).items() if k.startswith("FLAG_")}
    assert flags == {k: v for k, v in vars(jsam).items()
                     if k.startswith("FLAG_")}


def test_dna_and_parse_cigar_equal_jax():
    _index, batch, recs = _port_records()
    for row in batch.bases:
        np.testing.assert_array_equal(dna.revcomp(row), jdna.revcomp(row))
        np.testing.assert_array_equal(dna.complement(row),
                                      jdna.complement(row))
        assert dna.decode(row) == jdna.decode(row)
        np.testing.assert_array_equal(dna.encode(dna.decode(row)),
                                      jdna.encode(jdna.decode(row)))
    kmer = batch.bases[0, :32]
    assert dna.pack_kmer(kmer) == jdna.pack_kmer(kmer)
    np.testing.assert_array_equal(dna.unpack_kmer(dna.pack_kmer(kmer), 32),
                                  jdna.unpack_kmer(jdna.pack_kmer(kmer), 32))
    np.testing.assert_array_equal(dna.BASE_TO_CODE, jdna.BASE_TO_CODE)
    cigars = [r.cigar for r in recs if r.cigar != "*"] + ["5S10M2I3D7M4S"]
    assert any("I" in c or "D" in c for c in cigars)
    for c in cigars:
        assert bam.parse_cigar(c) == jbam.parse_cigar(c)


def _assert_res_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def test_clippers_equal_jax_on_indel_fixture():
    from test_torch_aligner import _indel_fixture
    from test_torch_defaults import clips

    jidx, batch = _indel_fixture()
    index = to_port_index(jidx)
    adapter = "AGATCGGAAGAGCACACGTCT"
    # adapter read-through on a few tails: 12 bases, 6 bases and 8 bases
    # with one mismatch
    raw = batch.bases.copy()
    for row, n in ((20, 12), (21, 6), (22, 8)):
        raw[row, -n:] = dna.encode(adapter[:n])
    raw[22, -3] = (raw[22, -3] + 1) % 4
    outs = []
    for mod in (clippers, jclippers):
        b, q = raw.copy(), batch.quals.copy()
        trims = mod.adapter_trim_batch(b, q, [adapter, "CTGTCTCTTATA"])
        outs.append((trims, b, q))
    for x, y in zip(*outs):
        np.testing.assert_array_equal(x, y)
    assert (outs[0][0][20:23] > 0).all()

    # the device results of the port's pipeline, adapter-masked as above
    al = Aligner.create(index, read_len=100, device="cpu",
                        adapters=(adapter,))
    out, bases, quals, trims, _ = al._dispatch(
        dataclasses.replace(batch, bases=raw))
    np.testing.assert_array_equal(trims, outs[0][0])
    res0 = {k: v.cpu().numpy() for k, v in out.items()}
    assert res0["qtrim"].any()
    # one alignment overhangs the contig end; a few rows take the
    # semialigned clip, one of them already carrying a gapped CIGAR
    row = int([r for r in np.nonzero(res0["aligned"] & (trims == 0)
                                     & (res0["qtrim"] == 0))[0]
               if r >= 40][0])
    res0["start"][row] = index.genome.total_length - 60
    res0["sa_do"][[30, 31, 32]] = True
    res0["sa_lead"][[30, 31, 32]] = [3, 0, 2]
    res0["sa_tail"][[30, 31, 32]] = [0, 4, 1]
    res0["sa_removed"][[30, 31, 32]] = 1
    results = []
    for mod in (clippers, jclippers):
        res = copy.deepcopy(res0)
        res["cigar"] = [None] * len(batch.names)
        res["cigar"][32] = "50M2I48M"
        b, q = bases.copy(), quals.copy()
        total = mod.apply_quality_trim_masks(b, q, trims, res.pop("qtrim"))
        mod.apply_masked_tail_cigar(res, "", total, batch.read_len)
        mod.clip_contig_ends(res, "", index.genome, batch.read_len)
        if mod is clippers:
            mod.apply_semialigned_device(res, "", batch.read_len,
                                         index.genome.codes, b)
        else:
            mod.apply_semialigned_device(res, "", batch.read_len)
        results.append((res, b, q, total))
    (res_t, b_t, q_t, tot_t), (res_j, b_j, q_j, tot_j) = results
    # the port recounts NM over the bases a semialigned clip leaves aligned
    # (the clip reference's edits); the JAX package subtracts sa_removed,
    # which the rows clipped by hand here hold at 1 whatever the clip took
    # (ROADMAP section C): the port's NM is the reference's on both, and
    # NM parts on exactly those where the JAX package's is not
    wrong = set()
    for i in (30, 31):
        seq = b_t[i]
        if res_t["reverse"][i]:
            seq = dna.revcomp(seq)
        want = clips.edits(index.genome.codes, seq, int(res_t["start"][i]),
                           clips.parse(res_t["cigar"][i], batch.read_len))
        assert int(res_t["edit_distance"][i]) == want
        if int(res_j["edit_distance"][i]) != want:
            wrong.add(i)
    touched = np.nonzero(res_t["edit_distance"] != res_j["edit_distance"])[0]
    assert wrong and set(touched.tolist()) == wrong
    res_j["edit_distance"][touched] = res_t["edit_distance"][touched]
    _assert_res_equal(res_t, res_j)
    np.testing.assert_array_equal(b_t, b_j)
    np.testing.assert_array_equal(q_t, q_j)
    np.testing.assert_array_equal(tot_t, tot_j)
    cig = res_t["cigar"]
    assert cig[row].endswith("S") and cig[32] == "50M2I48M"
    assert cig[30].startswith("3S") and cig[31].endswith("4S")
    assert sum(c is not None and c.endswith("S") for c in cig) > 4
    assert clippers.CONSECUTIVE_MATCHES_MIN == jclippers.CONSECUTIVE_MATCHES_MIN
    assert clippers.MASK_READ_LENGTH_MIN == jclippers.MASK_READ_LENGTH_MIN


def test_trace_batch_equals_jax(capsys):
    res = {"aligned": np.array([True, False]), "start": np.array([7, 0]),
           "mapq": np.array([60, 0]),
           "cand_start": np.array([[7, 9], [0, 0]]),
           "cand_valid": np.array([[True, True], [False, False]])}
    lines = []
    for mod in (tracing, jtracing):
        mod.set_trace_reads(["r0"])
        try:
            mod.trace_batch(["r0", "r1"], res)
        finally:
            mod.set_trace_reads(None)
        err = capsys.readouterr().err
        lines.append([ln.split("\t", 1)[-1] for ln in err.splitlines()])
    assert lines[0] == lines[1]
    assert any("candidates[2]" in ln for ln in lines[0])


def test_genome_and_fasta_equal_jax(tmp_path):
    from isaac_aligner_tpu.io import fasta as jfasta

    text = b">c1 desc\nACGTN\nacgt\n\n>c2\nGGGGCCCC\n"
    for gz in (False, True):
        path = tmp_path / ("g.fa.gz" if gz else "g.fa")
        path.write_bytes(gzip.compress(text) if gz else text)
        got, want = fasta.read_fasta(path), jfasta.read_fasta(path)
        np.testing.assert_array_equal(got.codes, want.codes)
        assert [dataclasses.asdict(c) for c in got.contigs] == \
            [dataclasses.asdict(c) for c in want.contigs]
        for p in (0, 8, 9, 16):
            assert got.to_local(p) == want.to_local(p)
            assert got.contig_of(p).name == want.contig_of(p).name
