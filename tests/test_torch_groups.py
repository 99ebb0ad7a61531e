"""Port's contig-group references vs the JAX package's, on the CPU: the
groups module and its manifest, MultiIndexAligner and
MultiIndexPairedAligner merged fields (the cross-group repeat included),
group-major swapping in the library, and workflow sorted.bam/.bai/.md5
byte-equal to the JAX workflow's for comma-separated FASTAs, a grouped
directory from the port's sort-reference, FASTA auto-grouping, group-major
runs and an annotated index."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

from isaac_aligner_tpu import dna as jdna
from isaac_aligner_tpu.align.pairs import TlsStatic as JTls
from isaac_aligner_tpu.index import groups as jgroups
from isaac_aligner_tpu.index.build import build_index as jbuild_index
from isaac_aligner_tpu.io.fasta import genome_from_sequences
from isaac_aligner_tpu.io.fastq import ReadBatch
from isaac_aligner_tpu.parallel import multi_index as jmi
from isaac_aligner_tpu.workflow import align as jwf
from isaac_aligner_tpu_torch.align.pairs import TlsStatic
from isaac_aligner_tpu_torch.cli import main as tcli
from isaac_aligner_tpu_torch.index import groups
from isaac_aligner_tpu_torch.io.bam import read_bam
from isaac_aligner_tpu_torch.io.fastq import ReadBatch as TReadBatch
from isaac_aligner_tpu_torch.parallel import multi_index as mi
from isaac_aligner_tpu_torch.workflow import align as wf

from test_grouped_reference import _genome
from test_multi_index import _seqs
from test_torch_host import to_port_index
from test_torch_neighbors import _dir_bytes, _write_fasta, port_genome
from test_torch_workflow import _env

OUTPUTS = ("sorted.bam", "sorted.bam.bai", "sorted.bam.md5")


def test_split_and_subset_equal_jax():
    g = _genome()
    for limit in (4_000, 6_000, 7_500, 9_000, 10**6):
        assert groups.split_genome_groups(g.contigs, limit) == \
            jgroups.split_genome_groups(g.contigs, limit)
    with pytest.raises(ValueError) as want:
        jgroups.split_genome_groups(g.contigs, 3_000)
    with pytest.raises(ValueError) as got:
        groups.split_genome_groups(g.contigs, 3_000)
    assert str(got.value) == str(want.value)
    sub, jsub = (groups.subset_genome(port_genome(g), ["cB", "cC"]),
                 jgroups.subset_genome(g, ["cB", "cC"]))
    np.testing.assert_array_equal(sub.codes, jsub.codes)
    assert [dataclasses.asdict(c) for c in sub.contigs] == \
        [dataclasses.asdict(c) for c in jsub.contigs]
    assert (groups.MANIFEST, groups.GROUP_LIMIT) == \
        (jgroups.MANIFEST, jgroups.GROUP_LIMIT)


@pytest.mark.parametrize("annotate,streaming", [(False, False), (True, False),
                                                (True, True)])
def test_grouped_indexes_equal_jax(tmp_path, annotate, streaming):
    g = _genome(seed=9)
    kw = dict(limit=6_000, annotate_neighbors=annotate, streaming=streaming,
              mask_width=3, work_dir=tmp_path)
    jdirs = jgroups.build_grouped_indexes(g, tmp_path / "j", **kw)
    dirs = groups.build_grouped_indexes(port_genome(g), tmp_path / "t",
                                        device="cpu", **kw)
    assert [d.name for d in dirs] == [d.name for d in jdirs] == \
        ["group_00", "group_01"]
    assert _dir_bytes(tmp_path / "t") == _dir_bytes(tmp_path / "j")
    assert groups.is_grouped_reference(tmp_path / "t")
    for mmap in (False, True):
        loaded = groups.load_grouped_indexes(tmp_path / "t", mmap=mmap)
        jloaded = jgroups.load_grouped_indexes(tmp_path / "j")
        for ix, jix in zip(loaded, jloaded):
            for name in ("key_hi", "key_lo", "pos"):
                np.testing.assert_array_equal(getattr(ix, name),
                                              getattr(jix, name))
            assert (ix.has_neighbors is None) == (not annotate)


def _batch(cls, rows, names):
    bases = np.stack(rows).astype(np.uint8)
    return cls(names=list(names), bases=bases,
               quals=np.full(bases.shape, 35, np.uint8),
               lengths=np.full(len(rows), bases.shape[1], np.int32))


def _single_fixture(which: str):
    """(JAX group indexes, read rows, names, read length) of the
    `tests/test_multi_index.py` fixtures."""
    if which == "two_groups":
        sa, sb = _seqs()
        combined = genome_from_sequences([("cA", sa), ("cB", sb)])
        gb = genome_from_sequences([("cB", sb)])
        L = 80
        rows, names = [], []
        for s in (500, 3000):
            rows.append(combined.codes[s:s + L])
            names.append(f"a{s}")
        for s in (800, 4200):
            rows.append(gb.codes[s:s + L])
            names.append(f"b{s}")
        rows.append(jdna.revcomp(combined.codes[5000:5000 + L]))
        names.append("rc5000")
        rows.append(np.full(L, 4, np.uint8))
        names.append("allN")
        gs = [genome_from_sequences([("cA", sa)]), gb]
    else:
        rng = np.random.default_rng(67)
        core = "".join("ACGT"[i] for i in rng.integers(0, 4, 120))
        pad = lambda n: "".join("ACGT"[i] for i in rng.integers(0, 4, n))
        gs = [genome_from_sequences([("cA", pad(2000) + core + pad(2000))]),
              genome_from_sequences([("cB", pad(1500) + core + pad(2500))])]
        L = 100
        rows = [gs[0].codes[2010:2010 + L], gs[0].codes[300:300 + L]]
        names = ["rep", "uniq"]
    return [jbuild_index(g, seed_len=32) for g in gs], rows, names, L


def _assert_merged_equal(got: dict, want: dict, floor_keys=()):
    assert got.keys() == want.keys()
    for k in want:
        a, b = got[k], want[k]
        if isinstance(b, list):
            assert list(a) == list(b), k
        elif k in floor_keys:
            d = np.abs(np.asarray(a, np.int64) - np.asarray(b, np.int64))
            assert d.max(initial=0) <= 1 and (d > 0).sum() <= 1, k
        elif np.asarray(b).dtype.kind == "f":
            a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
            fin = np.isfinite(b)
            np.testing.assert_array_equal(np.isfinite(a), fin, err_msg=k)
            np.testing.assert_allclose(a[fin], b[fin], rtol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=k)


@pytest.mark.parametrize("which", ["two_groups", "cross_group_repeat"])
def test_multi_index_aligner_fields_equal_jax(which):
    jidx, rows, names, L = _single_fixture(which)
    want = jmi.MultiIndexAligner.create(
        jidx, read_len=L, base_quality_cutoff=0).align_batch_arrays(
            _batch(ReadBatch, rows, names))
    al = mi.MultiIndexAligner.create([to_port_index(j) for j in jidx],
                                     read_len=L, base_quality_cutoff=0,
                                     device="cpu")
    got = al.align_batch_arrays(_batch(TReadBatch, rows, names))
    _assert_merged_equal(got, want, floor_keys=("mapq",))
    recs = {r.qname: r for r in
            al.align_to_sam(_batch(TReadBatch, rows, names))}
    if which == "cross_group_repeat":
        assert recs["rep"].is_mapped and recs["rep"].mapq <= 3
        assert recs["uniq"].mapq >= 50
    else:
        assert recs["b800"].rname == "cB" and recs["b800"].pos == 801
        assert not recs["allN"].is_mapped
    assert al.sw_pairs == 0 and al.finder_stats["tally"]


def _paired_fixture():
    sa, sb = _seqs(seed=91)
    gs = [genome_from_sequences([("cA", sa)]),
          genome_from_sequences([("cB", sb)])]
    L = 70
    r1s, r2s, names = [], [], []
    for g, s in ((0, 800), (1, 1200), (0, 4000), (1, 200)):
        codes = gs[g].codes
        r1s.append(codes[s:s + L])
        r2s.append(jdna.revcomp(codes[s + 300 - L:s + 300]))
        names.append(f"p{g}_{s}")
    # a mate in the other group (disjoined across groups) and a shadow
    r1s.append(gs[0].codes[2500:2500 + L])
    r2s.append(jdna.revcomp(gs[1].codes[3000:3000 + L]))
    names.append("cross")
    r1s.append(gs[1].codes[600:600 + L])
    r2s.append(np.full(L, 4, np.uint8))
    names.append("shadow")
    return [jbuild_index(g, seed_len=32) for g in gs], r1s, r2s, names, L


@pytest.mark.parametrize("group_major", [False, True],
                         ids=["resident", "group_major"])
def test_multi_index_paired_fields_equal_jax(group_major):
    jidx, r1s, r2s, names, L = _paired_fixture()
    tls = dict(min=200, max=400, mate_min=200, mate_max=400, best0=1, best1=6)
    jal = jmi.MultiIndexPairedAligner.create(jidx, read_len=L,
                                             base_quality_cutoff=0)
    jal.tls = JTls(**tls)
    want = jal.align_batch_arrays(_batch(ReadBatch, r1s, names),
                                  _batch(ReadBatch, r2s, names))
    al = mi.MultiIndexPairedAligner.create(
        [to_port_index(j) for j in jidx], read_len=L, base_quality_cutoff=0,
        device="cpu", group_major=group_major)
    al.tls = TlsStatic(**tls)
    assert all(a.tls == al.tls for a in al.aligners)
    batches = [(_batch(TReadBatch, r1s, names), _batch(TReadBatch, r2s, names))]
    if group_major:
        assert all(a.arrays is None for a in al.aligners)
        (_bb, got), = list(al.align_results_many(batches))
        assert all(a.arrays is None for a in al.aligners)
    else:
        got = al.align_batch_arrays(*batches[0])
    _assert_merged_equal(got, want, floor_keys=(
        "frag_score_1", "frag_score_2", "template_score"))
    assert al.finder_stats["anomalous_pairs"] == \
        jal.finder_stats["anomalous_pairs"]
    assert got["proper_pair"][:4].all() and not got["proper_pair"][4]
    assert got["aligned_1"][5]


def test_group_major_library_equals_resident():
    jidx, rows, names, L = _single_fixture("two_groups")
    out = []
    for gm in (False, True):
        al = mi.MultiIndexAligner.create([to_port_index(j) for j in jidx],
                                         read_len=L, device="cpu",
                                         group_major=gm)
        res = [r for _b, r in al.align_results_many(
            [_batch(TReadBatch, rows, names)] * 2)]
        out.append((res, al.finder_stats))
    for a, b in zip(out[0][0], out[1][0]):
        _assert_merged_equal(a, b)
    assert out[0][1] == out[1][1] and len(out[0][1]["tally"]) == 2


# -- workflow ---------------------------------------------------------------

READ_LEN = 80
N_PAIRS = 200


@pytest.fixture(scope="module")
def wf_inputs(tmp_path_factory) -> Path:
    """Three 30 kbp contigs (the `tests/test_group_major.py` genome with a
    copy of a 300 bp region of c0 planted in c2, a substitution every 16th
    base, and every 30th pair read from that region with its 2nd and 3rd
    seeds damaged), one FASTA per contig and
    all together, 200 read pairs of 80 bp, and two index directories
    written by the port's sort-reference on the CPU: annotated and grouped
    one contig a group, and annotated whole."""
    d = tmp_path_factory.mktemp("grp_in")
    rng = np.random.default_rng(23)
    seqs = [rng.integers(0, 4, 30_000).astype(np.uint8) for _ in range(3)]
    near = seqs[0][5_000:5_300].copy()
    near[::16] = (near[::16] + 1) % 4
    seqs[2][20_000:20_300] = near
    g = genome_from_sequences([(f"c{i}", jdna.decode(s))
                               for i, s in enumerate(seqs)])
    _write_fasta(d / "ref.fa", g)
    for i, s in enumerate(seqs):
        _write_fasta(d / f"c{i}.fa",
                     genome_from_sequences([(f"c{i}", jdna.decode(s))]))
    qs = "I" * READ_LEN
    with open(d / "r1.fq", "w") as f1, open(d / "r2.fq", "w") as f2:
        for i in range(N_PAIRS):
            codes = seqs[i % 3]
            t = 300 + int(rng.integers(-20, 21))
            p = (5_000 + 20 * (i // 30) if i % 30 == 0
                 else int(rng.integers(0, 30_000 - t - 1)))
            r1 = codes[p:p + READ_LEN].copy()
            if i % 30 == 0:
                # only the first seed anchors: its k-mer has a neighbor
                r1[[40, 60]] = (r1[[40, 60]] + 1) % 4
            r2 = jdna.revcomp(codes[p + t - READ_LEN:p + t])
            f1.write(f"@q{i}\n{jdna.decode(r1)}\n+\n{qs}\n")
            f2.write(f"@q{i}\n{jdna.decode(r2)}\n+\n{qs}\n")
    for out, extra in (("gidx", ["--group-limit", "40000"]), ("aidx", []),
                       ("gidx64", ["--group-limit", "40000", "-s", "64",
                                   "--dont-annotate"])):
        assert tcli(["sort-reference", "-g", str(d / "ref.fa"), "-o",
                     str(d / out), "--device", "cpu"] + extra) == 0
    return d


CASES = {
    "comma_fastas_se": ({"reference": "{d}/c0.fa,{d}/c1.fa,{d}/c2.fa"},
                        False, False),
    "comma_fastas_pe": ({"reference": "{d}/c0.fa,{d}/c1.fa,{d}/c2.fa"},
                        True, False),
    "grouped_dir_pe": ({"reference": "{d}/gidx"}, True, False),
    "fasta_autogroup_se": ({"reference": "{d}/ref.fa", "group_limit": 40_000},
                           False, False),
    "group_major_se": ({"reference": "{d}/gidx"}, False, True),
    "group_major_pe": ({"reference": "{d}/gidx"}, True, True),
    "annotated_index_se": ({"reference": "{d}/aidx"}, False, False),
    "grouped_64mer_se": ({"reference": "{d}/gidx64", "seed_len": 64}, False,
                         False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_workflow_bam_equals_jax(wf_inputs, tmp_path, monkeypatch, case):
    kw, paired, group_major = CASES[case]
    d = wf_inputs
    kw = {k: v.format(d=d) if isinstance(v, str) else v
          for k, v in kw.items()}
    base = dict(output_dir="", fastq1=str(d / "r1.fq"),
                fastq2=str(d / "r2.fq") if paired else None, batch_size=64,
                tls_batches=2, records_per_bin=10_000, **kw)
    # the output process only where the run is short of other cases
    env = {} if case == "grouped_dir_pe" else {"ISAAC_TPU_OUTPUT_PROC": "0"}
    if group_major:
        env["ISAAC_TPU_HBM_GB"] = "0.000001"      # the JAX package's switch
        monkeypatch.setattr(wf, "device_memory_budget", lambda *_: 0)
    with _env(env):
        jwf.AlignWorkflow(jwf.WorkflowOptions(
            **{**base, "output_dir": str(tmp_path / "j")})).run()
        wf.AlignWorkflow(wf.WorkflowOptions(
            **{**base, "output_dir": str(tmp_path / "t")},
            device="cpu")).run()
    for name in OUTPUTS:
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name
    ms = json.loads((tmp_path / "t" / "Stats" /
                     "MatchSelectorStats.json").read_text())
    recs = read_bam(tmp_path / "t" / "sorted.bam")[2]
    aligned = [r for r in recs if r.is_mapped]
    assert len(recs) == N_PAIRS * (2 if paired else 1)
    assert len(aligned) >= 0.95 * len(recs)
    assert {r.rname for r in aligned} == {"c0", "c1", "c2"}
    if case == "annotated_index_se":
        assert "groups" not in ms
        # the reads on the planted near-copy lose their MAPQ
        planted = [r.mapq for r in aligned if int(r.qname[1:]) % 30 == 0]
        assert sum(q == 0 for q in planted) >= len(planted) // 2, planted
    else:
        assert ms["group_major"] is group_major
        assert len(ms["groups"]) == 3
    if paired:
        state = json.loads((tmp_path / "t" / "Temp" /
                            "AlignerState.json").read_text())
        jstate = json.loads((tmp_path / "j" / "Temp" /
                             "AlignerState.json").read_text())
        assert state["tls"] == jstate["tls"]


@pytest.mark.parametrize("threshold", [0, 100])
def test_budget_follows_read_length_and_groups(wf_inputs, tmp_path,
                                               monkeypatch, threshold):
    """The group-major decision asks for the budget of this run's batch
    size, read length, group count and neighbor pass."""
    d = wf_inputs
    asked = []

    def budget(*args):
        asked.append(args)
        return 0

    monkeypatch.setattr(wf, "device_memory_budget", budget)
    with _env({"ISAAC_TPU_OUTPUT_PROC": "0"}):
        wf.AlignWorkflow(wf.WorkflowOptions(
            reference=str(d / "gidx"), output_dir=str(tmp_path / "t"),
            fastq1=str(d / "r1.fq"), fastq2=str(d / "r2.fq"), batch_size=64,
            tls_batches=2, records_per_bin=10_000,
            neighborhood_size_threshold=threshold, device="cpu")).run()
    assert asked == [("cpu", 64, READ_LEN, 3, threshold > 0)]


# (templates, read length, groups resident, neighbor pass, bytes): the
# largest and the smallest single-end and paired peaks that
# scripts/torch_working_set.py measured on an H100 80GB HBM3 (700 W) beside
# the planes, and chip_smoke.py phase 13's paired run with the neighbor pass
MEASURED_WORKING_SETS = [
    (65_536, 251, 2, False, 2_227_960_320),
    (8_192, 100, 2, False, 139_672_576),
    (32_768, 100, 1, False, 578_778_112),
    (4_096, 251, 2, False, 413_939_712),
    (32_768, 251, 2, False, 1_187_687_424),
    (65_536, 251, 1, True, 5_530_464_256),
    (8_192, 100, 1, True, 359_502_848),
    (32_768, 100, 1, True, 1_419_504_612),
    # with the batch's device program replayed as a CUDA graph: the lesser
    # of the allocated peak plus the graph pool's free bytes and the
    # reserved peak
    (65_536, 251, 2, False, 6_429_731_328),
    (8_192, 100, 1, False, 218_103_808),
    (65_536, 251, 1, True, 8_111_783_936),
    (32_768, 251, 2, False, 3_422_129_152),
    (4_096, 100, 2, False, 197_595_648),
    (32_768, 251, 1, True, 4_517_265_408),
    (4_096, 251, 1, True, 877_784_064),
]


@pytest.mark.parametrize("templates,read_len,groups,neighbors,measured",
                         MEASURED_WORKING_SETS)
def test_working_set_model_covers_measurements(templates, read_len, groups,
                                               neighbors, measured):
    model = wf.batch_working_set(templates, read_len, groups, neighbors)
    assert measured <= model
    assert wf.batch_working_set(templates, read_len + 50, groups,
                                neighbors) > model
    assert wf.batch_working_set(templates, read_len, groups + 1,
                                neighbors) > model
    if not neighbors:
        assert wf.batch_working_set(templates, read_len, groups, True) > model
