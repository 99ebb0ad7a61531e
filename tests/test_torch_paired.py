"""Port's PairedAligner and paired AlignWorkflow vs the JAX package's, on
the CPU: TLS learning, SAM records on a fixture with proper, shadow
(rescued and not), disjoined, gapped, overlapping and repeat pairs, the
golden paired snapshot, and sorted.bam/.bai/.md5 byte-equal to the JAX
workflow's in every paired case (defaults, --tls, --mate-drift-range,
--bam-pessimistic-mapq, --mapq-threshold, several bins, in-process
conversion, a FASTQ lane directory, --scatter-repeats with the neighbor
pass), resume from a JAX TlsDone state, the
CLI with -2, and unequal read counts."""

import dataclasses
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from isaac_aligner_tpu import aligner as jaligner
from isaac_aligner_tpu import dna as jdna
from isaac_aligner_tpu.align import pairs as jpairs
from isaac_aligner_tpu.index.build import build_index
from isaac_aligner_tpu.io.fasta import genome_from_sequences
from isaac_aligner_tpu.io.fastq import ReadBatch
from isaac_aligner_tpu.workflow import align as jwf
from isaac_aligner_tpu_torch import dna
from isaac_aligner_tpu_torch.aligner import PairedAligner
from isaac_aligner_tpu_torch.align import pairs
from isaac_aligner_tpu_torch.io.bam import read_bam
from isaac_aligner_tpu_torch.io.fastq import ReadBatch as TReadBatch
from isaac_aligner_tpu_torch.ops import sw
from isaac_aligner_tpu_torch.workflow import align as wf

from test_golden_snapshot import GOLDEN_PE, _batch, _core, _fixture
from test_torch_defaults import clips, res_reference
from test_torch_host import to_port_index
from test_torch_workflow import _deletion_sites, _env

REPO = Path(__file__).resolve().parents[1]
BATCH = 128
OUTPUTS = ("sorted.bam", "sorted.bam.bai", "sorted.bam.md5")
L = 100


def _revcomp(r):
    return jdna.revcomp(np.asarray(r, np.uint8))


def pair_genome():
    """Two contigs: chrA (16 kbp, a 300 bp segment copied exactly at 3,000
    and 9,000, an 80 bp N island at 12,000) and chrB (4 kbp)."""
    rng = np.random.default_rng(44)
    a = rng.integers(0, 4, 16_000).astype(np.uint8)
    a[9_000:9_300] = a[3_000:3_300]
    a[12_000:12_080] = 4
    b = rng.integers(0, 4, 4_000).astype(np.uint8)
    return genome_from_sequences([("chrA", dna.decode(a)),
                                  ("chrB", dna.decode(b))])


def pair_rows(g: np.ndarray):
    """[(name, read1, read2, quals1, quals2)] on pair_genome's codes (chrB
    starts at 16,000): FRp and RFm pairs with inserts from N(300, 30) and
    1% substitutions, plus overlapping (short insert), gapped (5 bp and
    30 bp deletions in read 1), shadow pairs whose mate only the rescue
    places (a substitution every 10th base; two of them with the window
    hanging off chrA's start, one over the N island), unrescuable shadows
    (junk mates), disjoined pairs (mate on the other contig, or both ends
    forward), repeat pairs (one or both ends in the duplicated segment)
    and an all-N pair; random qualities with a few low-quality tails."""
    rng = np.random.default_rng(45)
    rows = []

    def mutate(r, frac=0.01):
        r = np.asarray(r, np.uint8).copy()
        m = rng.random(r.size) < frac
        r[m] = rng.integers(0, 4, int(m.sum()))
        return r

    def damage(r):
        r = np.asarray(r, np.uint8).copy()
        r[::10] = (r[::10] + 1 + rng.integers(0, 3, r[::10].size)) % 4
        return r

    def frp(p, ins):
        return g[p:p + L], _revcomp(g[p + ins - L:p + ins])

    for i in range(100):
        p = int(rng.integers(0, 15_400))
        ins = int(np.clip(rng.normal(300, 30), 220, 380))
        r1, r2 = frp(p, ins)
        if i % 2:                                  # RFm: the other strand
            r1, r2 = r2, r1
        rows.append((f"p{i}", mutate(r1), mutate(r2)))
    for i, ins in enumerate((150, 160, 170, 180, 190, 130)):
        p = 400 + 1_700 * i
        rows.append((f"ov{i}", *frp(p, ins)))
    for i, (p, k) in enumerate(((1_500, 5), (5_500, 30), (7_700, 5))):
        r1 = np.concatenate([g[p:p + 50], g[p + 50 + k:p + 100 + k]])
        rows.append((f"gap{i}", r1, _revcomp(g[p + 300 - L:p + 300])))
    for i, p in enumerate((2_200, 4_800, 10_100, 13_900)):
        r1, r2 = frp(p, 300)
        rows.append((f"sh{i}", r1, damage(r2)))
    for i, p in enumerate((5, 40)):           # window off chrA's start
        r1, r2 = frp(p, 250)
        rows.append((f"edge{i}", damage(r1), r2))
    r1, r2 = frp(11_750, 330)                 # window over the N island
    rows.append(("nisl0", r1, damage(r2)))
    for i, p in enumerate((6_100, 14_300)):
        rows.append((f"junk{i}", g[p:p + L],
                     rng.integers(0, 4, L).astype(np.uint8)))
    for i, (p, q) in enumerate(((2_600, 17_000), (8_100, 18_500))):
        rows.append((f"far{i}", g[p:p + L], _revcomp(g[q:q + L])))
    for i, p in enumerate((4_100, 6_600)):    # FF: no model in the best two
        rows.append((f"ff{i}", g[p:p + L], g[p + 200:p + 200 + L]))
    rows.append(("rep0", *frp(3_050, 320)))   # read 1 in the repeat
    rows.append(("rep1", *frp(9_050, 320)))
    r1, r2 = frp(3_000, 280)                  # both ends in the repeat
    rows.append(("rep2", r1, r2))
    rows.append(("allN", np.full(L, 4, np.uint8), np.full(L, 4, np.uint8)))
    out = []
    for name, r1, r2 in rows:
        q1 = rng.integers(26, 41, L).astype(np.uint8)
        q2 = rng.integers(26, 41, L).astype(np.uint8)
        if name in ("p3", "p4", "p5"):
            q1[-15:] = 5
        if name in ("p6", "p7"):
            q2[-12:] = 4
        out.append((name, np.asarray(r1, np.uint8), np.asarray(r2, np.uint8),
                    q1, q2))
    return out


@pytest.fixture(scope="module")
def fixture():
    genome = pair_genome()
    index = build_index(genome, seed_len=32)
    rows = pair_rows(genome.codes)
    return index, rows


def _batches(rows, mod=None):
    """(b1, b2) ReadBatches of the JAX package (mod None) or the port."""
    cls = TReadBatch if mod == "port" else ReadBatch
    names = [r[0] for r in rows]
    n = len(rows)

    def mk(col, qcol):
        return cls(names=list(names), bases=np.stack([r[col] for r in rows]),
                   quals=np.stack([r[qcol] for r in rows]),
                   lengths=np.full(n, L, np.int32))
    return mk(1, 3), mk(2, 4)


@pytest.fixture(scope="module")
def aligned(fixture):
    """Both packages' PairedAligners learn TLS from the fixture and align
    it as one batch."""
    index, rows = fixture
    jal = jaligner.PairedAligner.create(index, read_len=L)
    tal = PairedAligner.create(to_port_index(index), read_len=L, device="cpu")
    jb = _batches(rows)
    tb = _batches(rows, "port")
    jtls = jal.learn_tls([jb])
    ttls = tal.learn_tls([tb])
    before = sw.banded_sw.launches
    # align_to_sam is align_batch_arrays + _records_from_res: one run each
    jb = _batches(rows)
    tb = _batches(rows, "port")
    jres = jal.align_batch_arrays(*jb)
    tres = tal.align_batch_arrays(*tb)
    jrecs = jal._records_from_res(*jb, jres)
    trecs = tal._records_from_res(*tb, tres)
    return dict(jtls=jtls, ttls=ttls, jrecs=jrecs, trecs=trecs, jres=jres,
                tres=tres, tal=tal, jal=jal, launches=sw.banded_sw.launches
                - before)


def test_learn_tls_gives_the_jax_model(aligned):
    assert dataclasses.asdict(aligned["ttls"]) == \
        dataclasses.asdict(aligned["jtls"])
    t = aligned["ttls"]
    assert {t.best0, t.best1} == {1, 6}
    assert 100 <= t.min < 300 < t.max <= 400


def test_tls_static_matches_jax():
    fields = [(f.name, f.default) for f in dataclasses.fields(pairs.TlsStatic)]
    assert fields == [(f.name, f.default)
                      for f in dataclasses.fields(jpairs.TlsStatic)]
    for span, cap in ((1, 4096), (181, 4096), (300, 4096), (3000, 4096),
                      (4000, 4096), (5000, 4096), (600, 500), (300, 400)):
        assert pairs.quantize_rescue_window(span, cap) == \
            jpairs.quantize_rescue_window(span, cap)


def _fields(r):
    return r.to_line()


def test_sam_records_equal_jax_paired_aligner(aligned):
    jl = [_fields(r) for r in aligned["jrecs"]]
    tl = [_fields(r) for r in aligned["trecs"]]
    assert tl == jl
    assert aligned["launches"] == 0           # CPU: the plain SW version


def test_fixture_exercises_every_pair_kind(aligned):
    res = aligned["jres"]
    recs = {(r.qname, r.flag & 0xC0): r for r in aligned["jrecs"]}
    names = [r.qname for r in aligned["jrecs"]][::2]
    idx = {n: i for i, n in enumerate(names)}
    proper = res["proper_pair"]
    assert proper[[idx[f"p{i}"] for i in range(100)]].mean() > 0.9
    # shadows rescued (also off the contig start and over the N island)
    for n in ("sh0", "sh1", "sh2", "sh3", "edge0", "edge1", "nisl0"):
        assert recs[(n, 0x40)].is_mapped and recs[(n, 0x80)].is_mapped, n
    # junk mates stay unaligned; far and FF pairs stay disjoined
    for n in ("junk0", "junk1"):
        assert not recs[(n, 0x80)].is_mapped
    for n in ("far0", "far1", "ff0", "ff1"):
        assert recs[(n, 0x40)].is_mapped and not proper[idx[n]], n
    assert any("D" in recs[(f"gap{i}", 0x40)].cigar for i in range(3))
    assert sum("S" in recs[(f"ov{i}", e)].cigar for i in range(6)
               for e in (0x40, 0x80)) >= 4
    # read 1 of rep1 lies in the second repeat copy, but both copies pass
    # the loose TLS filter with equal keys: the first index wins the tie
    assert recs[("rep0", 0x40)].pos == recs[("rep1", 0x40)].pos == 3_051


@pytest.mark.parametrize("key", [
    "aligned_1", "aligned_2", "start_1", "start_2", "reverse_1", "reverse_2",
    "mismatches_1", "mismatches_2", "edit_distance_1", "edit_distance_2",
    "proper_pair", "pair_resolved", "template_length", "shadow_1",
    "shadow_2", "disjoined", "num_candidates_1", "num_candidates_2"])
def test_result_fields_equal_jax(aligned, key):
    t, j = np.asarray(aligned["tres"][key]), np.asarray(aligned["jres"][key])
    if key == "template_length":
        # the port works the pair step's template length out again from
        # the final placements of a pair whose end the gapped polish moved
        # (the pair step's rule: unclipped starts, read lengths; ROADMAP
        # §C11); the JAX package keeps the pair step's
        res = aligned["tres"]
        for i in np.nonzero(t != j)[0].tolist():
            p1, p2 = (clips.unclipped(int(res["start" + e][i]),
                                      res["cigar" + e][i], L)[0]
                      for e in ("_1", "_2"))
            want = clips.template_length(p1, L, p2, L)
            assert int(t[i]) == want != int(j[i]), i
            j = j.copy()
            j[i] = t[i]
    np.testing.assert_array_equal(t, j, key)


@pytest.mark.parametrize("key", ["log_prob_1", "log_prob_2", "pair_best_lp"])
def test_float_fields_within_f32_tolerance(aligned, key):
    t = np.asarray(aligned["tres"][key])
    j = np.asarray(aligned["jres"][key])
    fin = np.isfinite(j)
    np.testing.assert_array_equal(np.isfinite(t), fin)
    np.testing.assert_allclose(t[fin], j[fin], rtol=1e-5)


def _floor_flips(a, b, n_rows):
    d = np.abs(np.asarray(a, np.int64) - np.asarray(b, np.int64))
    assert d.max(initial=0) <= 1 and (d > 0).sum() <= max(1, 0.005 * n_rows)


@pytest.mark.parametrize("key", ["frag_score_1", "frag_score_2",
                                 "template_score"])
def test_scores_floor_flips_only(aligned, key):
    _floor_flips(aligned["tres"][key], aligned["jres"][key],
                 len(aligned["jres"][key]))


def test_cigars_equal_jax(aligned):
    for sfx in ("_1", "_2"):
        assert aligned["tres"]["cigar" + sfx] == aligned["jres"]["cigar" + sfx]


def test_paired_golden():
    """tests/test_golden_snapshot.py::test_paired_golden on the port."""
    genome, index = _fixture()
    g = genome.codes
    r1s, r2s = [], []
    for s in (1000, 5000):
        r1s.append(g[s:s + 70].copy())
        r2s.append(jdna.revcomp(g[s + 230:s + 300]))
    r1s[1][10] = (r1s[1][10] + 1) % 4
    al = PairedAligner.create(to_port_index(index), read_len=70,
                              base_quality_cutoff=0, device="cpu")
    al.tls = pairs.TlsStatic(min=200, max=400, mate_min=200, mate_max=400,
                             best0=1, best1=6)
    recs = al.align_to_sam(_batch(r1s, ["p0", "p1"]), _batch(r2s, ["p0", "p1"]))
    assert [_core(r) for r in recs] == GOLDEN_PE


def test_align_to_sam_many_in_order(fixture, aligned):
    _index, rows = fixture
    al = aligned["tal"]
    halves = [_batches(rows[a:b], "port") for a, b in ((0, 64),
                                                        (64, len(rows)))]
    many = [r.to_line() for recs in al.align_to_sam_many(halves)
            for r in recs]
    one = [r.to_line() for h in halves for r in al.align_to_sam(*h)]
    assert many == one
    assert al.finder_stats["anomalous_pairs"] > 0


def test_rescue_window_over_cap_is_counted(fixture):
    index, rows = fixture
    al = PairedAligner.create(to_port_index(index), read_len=L, device="cpu",
                              max_rescue_window=256)
    jal = jaligner.PairedAligner.create(index, read_len=L,
                                        max_rescue_window=256)
    wide = dict(min=100, max=900, mate_min=100, mate_max=900, best0=1,
                best1=6, median=400)
    al.tls = pairs.TlsStatic(**wide)
    jal.tls = jpairs.TlsStatic(**wide)
    trecs = al.align_to_sam(*_batches(rows, "port"))
    jrecs = jal.align_to_sam(*_batches(rows))
    assert [r.to_line() for r in trecs] == [r.to_line() for r in jrecs]
    assert al.finder_stats["rescue_skipped"] == \
        jal.finder_stats["rescue_skipped"] > 0


@pytest.mark.parametrize("n_bases", [99, 100], ids=["one_base", "all_n"])
def test_n_mate_is_rescued_as_proper_pair(fixture, n_bases):
    """ROADMAP §C5: a mate of N bases (a read from an N island) has no
    place of its own, yet the shadow rescue sets it beside read 1 and the
    pair comes out proper, in the JAX package and in the port alike (the
    rescue counts no N as a mismatch)."""
    index = fixture[0]
    g = index.genome.codes
    mate = np.full(L, 4, np.uint8)
    mate[37:37 + L - n_bases] = 2
    tls = dict(min=151, max=451, mate_min=151, mate_max=451, best0=6,
               best1=1, median=300)
    rows = [("nmate", g[5_000:5_000 + L], mate, np.full(L, 30, np.uint8),
             np.full(L, 30, np.uint8))]
    jal = jaligner.PairedAligner.create(index, read_len=L)
    tal = PairedAligner.create(to_port_index(index), read_len=L, device="cpu")
    jal.tls = jpairs.TlsStatic(**tls)
    tal.tls = pairs.TlsStatic(**tls)
    rj = jal.align_batch_arrays(*_batches(rows))
    b1, b2 = _batches(rows, "port")
    rt = tal.align_batch_arrays(b1, b2)
    for r in (rj, rt):
        assert bool(r["aligned_2"][0]) and bool(r["proper_pair"][0])
        assert int(r["start_1"][0]) == 5_000
        assert abs(int(r["start_2"][0]) - 5_000) <= 451
    for k in ("start_2", "frag_score_2", "template_length"):
        assert int(rt[k][0]) == int(rj[k][0]), k
    assert rt["cigar_2"][0] == rj["cigar_2"][0]
    # the overlap clip leaves the mate's N bases over read 1 out of its
    # alignment: the port's NM counts those still aligned (the clip
    # reference's), the JAX package's keeps every N (ROADMAP section C)
    want, _pair = res_reference(g, index.genome.contigs, rt, b1, b2, 0,
                                {"min": 151, "max": 451, "best": (6, 1)})
    assert "S" in rt["cigar_2"][0]
    assert (int(rt["start_2"][0]), rt["cigar_2"][0],
            int(rt["edit_distance_2"][0])) == \
        (want[1]["pos"], want[1]["cigar"], want[1]["nm"])
    assert int(rj["edit_distance_2"][0]) >= n_bases > want[1]["nm"]


def test_create_on_missing_card_raises(fixture):
    index = to_port_index(fixture[0])
    if torch.cuda.is_available():
        assert PairedAligner.create(index, read_len=L).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        PairedAligner.create(index, read_len=L)
    with pytest.raises(ValueError, match="longest read"):
        PairedAligner.create(index, read_len=sw.MAX_LEN + 1, device="cuda")


# ---------------------------------------------------------------------------
# The workflow
# ---------------------------------------------------------------------------

def write_pair_inputs(d: Path, rows=None, genome=None) -> Path:
    genome = genome or pair_genome()
    rows = rows if rows is not None else pair_rows(genome.codes)
    with open(d / "ref.fa", "w") as f:
        for c in genome.contigs:
            seq = dna.decode(genome.codes[c.offset:c.offset + c.length])
            f.write(f">{c.name}\n" + "\n".join(
                seq[i:i + 70] for i in range(0, len(seq), 70)) + "\n")
    for e, (col, qcol) in ((1, (1, 3)), (2, (2, 4))):
        with open(d / f"r{e}.fq", "w") as f:
            for r in rows:
                qual = (r[qcol] + 33).astype(np.uint8).tobytes().decode()
                f.write(f"@{r[0]}\n{dna.decode(r[col])}\n+\n{qual}\n")
    return d


#: templates of the workflow input: the fixture's 126 pairs, 40 copies
#: and 6 deletion pairs
N_TEMPLATES = 172


@pytest.fixture(scope="module")
def inputs(tmp_path_factory) -> Path:
    """The fixture's pairs, 40 of them again under new names (duplicates
    for the Build phase), and 3 deletions each read twice (read 1 crossing
    it mid-read, where the gapped polish finds it, and near its 3' end,
    where only the known-gap realignment does), as r1.fq/r2.fq and as a
    lane directory."""
    genome = pair_genome()
    g = genome.codes
    rows = pair_rows(g)
    rows = rows + [(f"d{r[0]}", *r[1:]) for r in rows[:40]]
    q35 = np.full(L, 35, np.uint8)
    for j, (p, k, d) in enumerate(_deletion_sites(g[:16_000])):
        mate = _revcomp(g[p + 200:p + 300])
        rows.append((f"gapw{j}", np.concatenate([g[p - 50:p],
                                                 g[p + k:p + k + 50]]),
                     mate, q35, q35))
        rows.append((f"near{j}", np.concatenate([g[p - 100 + d:p],
                                                 g[p + k:p + k + d]]),
                     mate, q35, q35))
    assert len(rows) == N_TEMPLATES
    d = write_pair_inputs(tmp_path_factory.mktemp("pe_in"), rows, genome)
    (d / "lanes").mkdir()
    for e in (1, 2):
        shutil.copy(d / f"r{e}.fq", d / "lanes" / f"lane1_read{e}.fastq")
    return d


def _opts(mod, d: Path, out: Path, **kw):
    base = dict(reference=str(d / "ref.fa"), output_dir=str(out),
                fastq1=str(d / "r1.fq"), fastq2=str(d / "r2.fq"),
                batch_size=BATCH)
    if mod is wf:
        base["device"] = "cpu"
    return mod.WorkflowOptions(**{**base, **kw})


CASES = {
    "defaults": ({}, {}),
    "tls_override": ({"tls_override": "230:300:370:20:20:1:6"}, {}),
    "mate_drift_range": ({"mate_drift_range": 40}, {}),
    "pessimistic_mapq": ({"pessimistic_mapq": True}, {}),
    "mapq_threshold": ({"mapq_threshold": 20}, {}),
    "several_bins": ({"records_per_bin": 60}, {}),
    "in_process": ({}, {"ISAAC_TPU_OUTPUT_PROC": "0"}),
    "lane_dir": ({"fastq1": "LANES", "fastq2": None}, {}),
    # the --scatter-repeats pair pick and the neighbor pass, on the
    # fixture's exact 300 bp repeat (a given TLS: no learning phase)
    "scatter_neighbors": ({"scatter_repeats": True,
                           "neighborhood_size_threshold": 100,
                           "tls_override": "230:300:370:20:20:1:6"},
                          {"ISAAC_TPU_OUTPUT_PROC": "0"}),
}


@pytest.fixture(scope="module")
def ran(inputs, tmp_path_factory):
    """case -> (JAX output dir, port output dir), each run once."""
    done: dict = {}

    def get(case: str):
        if case not in done:
            kw, env = CASES[case]
            if kw.get("fastq1") == "LANES":
                kw = {**kw, "fastq1": str(inputs / "lanes")}
            outs = []
            for mod in (jwf, wf):
                out = tmp_path_factory.mktemp(f"{case}_{mod.__name__[:18]}")
                with _env(env):
                    mod.AlignWorkflow(_opts(mod, inputs, out, **kw)).run()
                outs.append(out)
            done[case] = tuple(outs)
        return done[case]
    return get


def _stats(out: Path):
    ms = json.loads((out / "Stats" / "MatchSelectorStats.json").read_text())
    build = json.loads((out / "Stats" / "BuildStats.json").read_text())
    return ({k: ms[k] for k in ("total_reads", "aligned", "perfect",
                                "proper_pairs", "mapq_hist")},
            {k: build[k] for k in ("records", "duplicates", "realigned",
                                   "bins")})


@pytest.mark.parametrize("case", list(CASES))
def test_paired_bam_equals_jax_workflow(case, ran):
    jout, tout = ran(case)
    for name in OUTPUTS:
        assert (tout / name).read_bytes() == (jout / name).read_bytes(), name
    assert _stats(tout) == _stats(jout)
    jstate = json.loads((jout / "Temp" / "AlignerState.json").read_text())
    tstate = json.loads((tout / "Temp" / "AlignerState.json").read_text())
    assert tstate["tls"] == jstate["tls"]
    ms, build = _stats(jout)
    assert ms["total_reads"] == 2 * N_TEMPLATES
    assert ms["proper_pairs"] > 0.75 * N_TEMPLATES
    if case == "defaults":
        # both Build-phase paths really ran
        assert build["duplicates"] > 0 and build["realigned"] > 0
    if case == "several_bins":
        assert build["bins"] > 1
    if case == "mate_drift_range":
        t = tstate["tls"]
        assert (t["mate_min"], t["mate_max"]) == (t["median"] - 40,
                                                  t["median"] + 40)


def test_resume_from_jax_tls_state(inputs, ran, tmp_path):
    """A TlsDone state written by the JAX workflow resumes in the port
    and gives the JAX run's bytes."""
    jout, _ = ran("defaults")
    out = tmp_path / "resumed"
    first = jwf.AlignWorkflow(_opts(jwf, inputs, out))
    first.run(stop_at="TlsDone")
    state = json.loads((out / "Temp" / "AlignerState.json").read_text())
    assert state["state"] == "TlsDone" and "tls" in state
    second = wf.AlignWorkflow(_opts(wf, inputs, out))
    second.run(resume=True)
    assert second.state == "BamDone"
    assert dataclasses.asdict(second.tls) == state["tls"]
    for name in OUTPUTS:
        assert (out / name).read_bytes() == (jout / name).read_bytes(), name


def test_cli_paired_writes_the_same_bam(inputs, ran, tmp_path):
    jout, _ = ran("defaults")
    out = tmp_path / "cli"
    proc = subprocess.run(
        [sys.executable, "-m", "isaac_aligner_tpu_torch", "align",
         "-r", str(inputs / "ref.fa"), "-1", str(inputs / "r1.fq"),
         "-2", str(inputs / "r2.fq"), "-o", str(out),
         "--batch-size", str(BATCH), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for name in OUTPUTS:
        assert (out / name).read_bytes() == (jout / name).read_bytes(), name


def test_cli_paired_options_reach_the_workflow(inputs, tmp_path,
                                               monkeypatch):
    from isaac_aligner_tpu_torch import cli
    seen = {}

    class Stop(Exception):
        pass

    def fake(opts):
        seen["opts"] = opts
        raise Stop
    monkeypatch.setattr(wf, "AlignWorkflow", fake)
    with pytest.raises(Stop):
        cli.main(["align", "-r", "ref.fa", "-1", "a.fq", "-2", "b.fq",
                  "-o", str(tmp_path), "--tls", "1:2:3:4:5:1:6",
                  "--mate-drift-range", "7", "--bam-pessimistic-mapq",
                  "--shadow-scan-range", "9", "--no-clip-overlapping"])
    o = seen["opts"]
    assert (o.fastq2, o.tls_override, o.mate_drift_range, o.pessimistic_mapq,
            o.shadow_scan_range, o.clip_overlapping) == \
        ("b.fq", "1:2:3:4:5:1:6", 7, True, 9, False)


def test_unequal_read_counts_raise(inputs, tmp_path):
    lines = (inputs / "r2.fq").read_text().splitlines(keepends=True)
    (tmp_path / "short.fq").write_text("".join(lines[:-4]))
    with pytest.raises(ValueError, match="read counts differ"):
        wf.AlignWorkflow(_opts(wf, inputs, tmp_path / "out",
                               fastq2=str(tmp_path / "short.fq"))).run()


def test_paired_default_device_is_the_card(inputs, tmp_path):
    opts = wf.WorkflowOptions(reference=str(inputs / "ref.fa"),
                              output_dir=str(tmp_path / "out"),
                              fastq1=str(inputs / "r1.fq"),
                              fastq2=str(inputs / "r2.fq"))
    assert opts.device == "cuda"
    if torch.cuda.is_available():
        return
    run = wf.AlignWorkflow(opts)
    with pytest.raises(RuntimeError, match="cuda"):
        run.run()
    assert run.state == "Start" and run.tls is None


def test_paired_records_place_every_pair(ran, fixture):
    """The port's BAM: two records per template, R1/R2 flags, mates
    pointing at each other."""
    _, tout = ran("defaults")
    recs = read_bam(tout / "sorted.bam")[2]
    by_name: dict = {}
    for r in recs:
        by_name.setdefault(r.qname, []).append(r)
    assert all(len(v) == 2 for v in by_name.values())
    for name, (a, b) in by_name.items():
        assert {a.flag & 0xC0, b.flag & 0xC0} == {0x40, 0x80}, name
        if a.is_mapped and b.is_mapped:
            assert a.pnext == b.pos and b.pnext == a.pos
            assert a.tlen == -b.tlen


def test_paired_output_process_child_needs_no_torch(tmp_path):
    """The spawned child's paired branch, run in a fresh interpreter on one
    converted pair batch, imports no torch and counts proper pairs."""
    script = f"""
import queue, sys
import numpy as np
from isaac_aligner_tpu_torch.workflow import output_proc
from isaac_aligner_tpu_torch.io.fastq import LazyNames
names = LazyNames.from_list(["a", "b", "__pad0"])
res = {{}}
for e, start, rev in ((1, [120, 0, 0], [0, 0, 0]), (2, [300, 500, 0], [1, 1, 0])):
    res[f"aligned_{{e}}"] = np.array([1, e - 1, 0], bool)
    res[f"reverse_{{e}}"] = np.array(rev, bool)
    res[f"start_{{e}}"] = np.array(start, np.int32)
    res[f"frag_score_{{e}}"] = np.array([40, 30, 0], np.int32)
    res[f"edit_distance_{{e}}"] = np.array([0, 1, 0], np.int32)
res["proper_pair"] = np.array([1, 0, 0], bool)
res["template_score"] = np.array([60, -1, -1], np.int32)
bases = np.zeros((3, 10), np.uint8)
quals = np.full((3, 10), 30, np.uint8)
lens = np.array([10, 10, 0], np.int32)
q, rq = queue.Queue(), queue.Queue()
q.put((0, 2, names.mat, names.lens, None, (bases, quals, lens),
       (bases, quals, lens), res))
q.put(None)
output_proc._child_main(dict(
    bins_dir={str(tmp_path / 'bins')!r}, contig_offsets=np.array([0, 1000]),
    genome_bp=2000, n_bins=1, sample_cap=8, pre_sort=True, uniform=False,
    mapq_cap=60, mapq_threshold=0, paired=True, pessimistic=False), q, rq)
status, out = rq.get()
assert status == "ok", out
st = out["stats"]
assert (st["total_reads"], st["aligned"], st["proper_pairs"]) == (4, 3, 1), st
assert "torch" not in sys.modules
print("OK")
"""
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "OK" in proc.stdout
    assert list((tmp_path / "bins").glob("bin_00000/chunk_*.cols"))
