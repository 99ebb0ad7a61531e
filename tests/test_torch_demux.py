"""Demultiplexing in the port vs the JAX package, on the CPU.

The port's copies of `demultiplexing/` (sample sheets; barcode resolution,
single and dual index, mismatch budgets 0-2) and of the barcode FASTQ
stream against the originals, then two workflows with per-sample outputs
(sorted.bam, .bai, .md5 of each sample and the Stats JSON) equal to the
JAX workflow's: FASTQ pairs plus a barcode FASTQ under a sample sheet,
and the per-barcode driver (`workflow/per_barcode.py`), whose samples
align against their own references with their own learned TLS, one of
them "unmapped".
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

from isaac_aligner_tpu import demultiplexing as jdemux
from isaac_aligner_tpu.io import fastq as jfastq
from isaac_aligner_tpu.workflow import align as jwf
from isaac_aligner_tpu.workflow import per_barcode as jper_barcode
from isaac_aligner_tpu_torch import demultiplexing as demux
from isaac_aligner_tpu_torch import dna, synthetic
from isaac_aligner_tpu_torch.io import fastq
from isaac_aligner_tpu_torch.io.bam import read_bam
from isaac_aligner_tpu_torch.workflow import align as wf
from isaac_aligner_tpu_torch.workflow import per_barcode

from test_torch_bcl import assert_outputs_equal, output_files
from test_torch_defaults import assert_outputs_equal_but_mended
from test_torch_paired import pair_genome, write_pair_inputs

BATCH = 64

SHEETS = {
    "single": "barcode,sample,project\nACGTACGT,sA,p1\nTTTTCCCC,sB,p1\n",
    "dual_lanes": "Barcode,Sample,Lane\nACGT-TTGC,d1,1\nGGCA-ACAC,d2,2\n",
    "no_index": "barcode,sample\nnone,only\n",
    "per_barcode": ("barcode,sample,reference,adapter\n"
                    "ACGTACGT,a,/x/ref.fa,AGATCG+CTGTCT\n"
                    "TTTTCCCC,b,unmapped,\n"),
    "no_sample_column": "barcode,name\nACGT,x\n",
    "empty": "barcode,sample\n",
}


@pytest.mark.parametrize("sheet", list(SHEETS))
def test_sample_sheet_equals_jax(tmp_path, sheet):
    path = tmp_path / "s.csv"
    path.write_text(SHEETS[sheet])
    outs = []
    for mod in (demux, jdemux):
        try:
            specs = mod.parse_sample_sheet(path)
            outs.append([(dataclasses.asdict(s), s.components, s.is_no_index,
                          s.adapters, s.is_unmapped_reference)
                         for s in specs])
        except ValueError as e:
            outs.append(str(e))
    assert outs[0] == outs[1]
    if not isinstance(outs[0], str):
        assert per_barcode.sheet_has_per_barcode_columns(path) == \
            (sheet == "per_barcode")


@pytest.mark.parametrize("budget", [0, 1, 2])
@pytest.mark.parametrize("layout", ["single", "dual"])
def test_resolve_barcodes_equals_jax(tmp_path, layout, budget):
    """Observed barcodes: exact, one to three substitutions (in one or
    both components), Ns and random ones, against four barcodes."""
    rng = np.random.default_rng(budget)
    codes = synthetic.make_barcodes(rng, 4, 8, min_distance=5)
    if layout == "dual":
        rows = [f"{c[:4]}-{c[4:]}" for c in codes]
    else:
        rows = codes
    path = tmp_path / "s.csv"
    path.write_text("barcode,sample\n" + "".join(
        f"{b},s{i}\n" for i, b in enumerate(rows)))
    obs, _sample, _mm = synthetic.barcode_reads(rng, 600, codes, 0.3, 0.1)
    k = rng.integers(0, 8, (600, 2))
    obs[np.arange(0, 600, 3), k[::3, 0]] = (obs[np.arange(0, 600, 3),
                                                 k[::3, 0]] + 1) % 4
    obs[np.arange(0, 600, 7), k[::7, 1]] = dna.N
    got = demux.resolve_barcodes(obs, demux.parse_sample_sheet(path), budget)
    want = jdemux.resolve_barcodes(obs, jdemux.parse_sample_sheet(path),
                                   budget)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    assert (got >= 0).any() and (got < 0).any()


def test_barcode_fastq_stream_equals_jax(tmp_path):
    d = write_pair_inputs(tmp_path)
    bars = _write_barcode_fastq(d, list(range(126)))
    for bs in (16, 50):
        got = list(fastq.iter_fastq_batches(d / "r1.fq", d / "r2.fq", bs,
                                            barcode_path=d / "i1.fq"))
        want = list(jfastq.iter_fastq_batches(d / "r1.fq", d / "r2.fq", bs,
                                              barcode_path=d / "i1.fq"))
        assert len(got) == len(want)
        for (g1, g2, gbc), (w1, w2, wbc) in zip(got, want):
            np.testing.assert_array_equal(gbc, wbc)
            assert gbc.shape == (g1.n_valid, 8)
            for a, b in ((g1, w1), (g2, w2)):
                assert list(a.names) == list(b.names)
                np.testing.assert_array_equal(a.bases, b.bases)
        np.testing.assert_array_equal(
            np.concatenate([g[2] for g in got]),
            np.stack([dna.encode(b) for b in bars]))
    lines = (d / "i1.fq").read_text().splitlines(keepends=True)
    (d / "short.fq").write_text("".join(lines[:-4]))
    with pytest.raises(ValueError, match="barcode FASTQ read count"):
        list(fastq.iter_fastq_batches(d / "r1.fq", None, 64,
                                      barcode_path=d / "short.fq"))


# -- workflows --------------------------------------------------------------

#: sample -> (barcode, insert, reference FASTA or "unmapped")
SAMPLES = {"A": ("ACGTACGT", 300, "ref.fa"),
           "B": ("TGCATGCA", 450, "refB.fa"),
           "C": ("CATGGTAC", 300, "unmapped")}


def _write_barcode_fastq(d: Path, sample_of: list, rng=None) -> list[str]:
    """d/i1.fq: one 8-base index read per read-1 record, the barcode of
    its sample (an int picks SAMPLES in turn, a letter names one; None is
    a random barcode)."""
    rng = rng or np.random.default_rng(1)
    names = [ln[1:].strip() for ln in
             (d / "r1.fq").read_text().splitlines()[::4]]
    keys = list(SAMPLES)
    bars = []
    with open(d / "i1.fq", "w") as f:
        for name, s in zip(names, sample_of):
            if s is None:
                b = "".join("ACGT"[x] for x in rng.integers(0, 4, 8))
            else:
                b = SAMPLES[keys[s % 3] if isinstance(s, int) else s][0]
            bars.append(b)
            f.write(f"@{name}\n{b}\n+\n{'I' * 8}\n")
    return bars


def write_inputs(d: Path) -> Path:
    """ref.fa (pair_genome) and refB.fa (another 12 kbp genome); 140 pairs
    of each sample (A on ref.fa with N(300, 30) inserts, B on refB.fa with
    N(450, 30), C on ref.fa) and 40 of random barcodes (on ref.fa); the
    run's r1/r2/i1 FASTQs, sheet.csv (barcode,sample) and per_barcode.csv
    (with each sample's reference)."""
    rng = np.random.default_rng(21)
    genome = pair_genome()
    g_b = rng.integers(0, 4, 12_000).astype(np.uint8)
    (d / "refB.fa").write_text(">chrZ\n" + dna.decode(g_b) + "\n")
    rows, samples = [], []
    for s, (_bc, ins, _ref) in [*SAMPLES.items(), (None, (None,) * 3)]:
        n = 40 if s is None else 140
        codes = g_b if s == "B" else genome.codes[:16_000]
        ins = ins or 300
        sp = synthetic.make_pairs(rng, codes, n, far_frac=0.0,
                                  insert=(ins, 30.0),
                                  insert_range=(ins - 100, ins + 100),
                                  damaged_frac=0.03)
        q = np.full(100, 35, np.uint8)
        rows += [(f"{s or 'u'}{i}", sp.bases1[i], sp.bases2[i], q, q)
                 for i in range(n)]
        samples += [s] * n
    order = rng.permutation(len(rows))
    rows = [rows[i] for i in order]
    write_pair_inputs(d, rows, genome)
    _write_barcode_fastq(d, [samples[i] for i in order], rng)
    (d / "sheet.csv").write_text("barcode,sample\n" + "".join(
        f"{bc},{s}\n" for s, (bc, _i, _r) in SAMPLES.items()))
    (d / "per_barcode.csv").write_text(
        "barcode,sample,reference\n" + "".join(
            f"{bc},{s},{ref if ref == 'unmapped' else d / ref}\n"
            for s, (bc, _i, ref) in SAMPLES.items()))
    return d


@pytest.fixture(scope="module")
def inputs(tmp_path_factory) -> Path:
    return write_inputs(tmp_path_factory.mktemp("demux_in"))


CASES = {"fastq_barcodes": "sheet.csv", "per_barcode": "per_barcode.csv"}


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
                          fastq1=str(inputs / "r1.fq"),
                          fastq2=str(inputs / "r2.fq"),
                          barcode_fastq=str(inputs / "i1.fq"),
                          sample_sheet=str(inputs / CASES[case]),
                          tls_batches=2, bam_exclude_tags="none")
                if mod is wf:
                    kw["device"] = "cpu"
                mod.AlignWorkflow(mod.WorkflowOptions(**kw)).run()
                outs.append(out)
            done[case] = tuple(outs)
        return done[case]
    return get


def _qnames(bam: Path) -> list[str]:
    return [r.qname for r in read_bam(bam)[2]]


def test_fastq_barcode_workflow_equals_jax(ran):
    """Byte-equal to the JAX workflow but for the pairs a fault of the JAX
    package's that the port mends touches (ROADMAP section C; here sample
    C's template C87, whose read 2 the JAX overlap clip cuts from read 1's
    whole length though read 1's semialigned clip left 35 bases aligned,
    and unknown's u8, whose proper flag the port works out again after the
    gapped polish moved an end): there the port's records hold to the clip
    reference and JAX's do not, and the Stats count the port's proper
    pairs (`test_torch_defaults.assert_outputs_equal_but_mended`)."""
    jout, tout = ran("fastq_barcodes")
    touched = assert_outputs_equal_but_mended(jout, tout, pair_genome())
    assert touched == {"C/sorted.bam": {"C87"}, "unknown/sorted.bam": {"u8"}}
    names = output_files(tout)
    assert {"A/sorted.bam", "B/sorted.bam", "C/sorted.bam",
            "unknown/sorted.bam", "Stats/DemultiplexingStats.json"} \
        <= set(names)
    counts = json.loads((tout / "Stats" / "DemultiplexingStats.json")
                        .read_text())
    assert counts == {"A": 140, "B": 140, "C": 140, "unknown": 40}
    for s in ("A", "B", "C"):
        recs = read_bam(tout / s / "sorted.bam")[2]
        assert {r.qname[0] for r in recs} == {s}
        assert all(r.tags["BC"] == ("Z", SAMPLES[s][0]) for r in recs)
    # B's reads come from refB.fa: they do not place on the run's -r
    b = read_bam(tout / "B" / "sorted.bam")[2]
    assert sum(r.is_mapped for r in b) < 0.2 * len(b)


def test_per_barcode_driver_equals_jax(ran):
    jout, tout = ran("per_barcode")
    names = assert_outputs_equal(jout, tout)
    assert {"A/sorted.bam", "B/sorted.bam", "C/sorted.bam",
            "unknown/sorted.bam", "Stats/PerBarcodeStats.json"} <= set(names)
    assert (tout / "Stats" / "PerBarcodeStats.json").read_bytes() == \
        (jout / "Stats" / "PerBarcodeStats.json").read_bytes()
    stats = json.loads((tout / "Stats" / "PerBarcodeStats.json").read_text())
    assert abs(stats["A"]["tls"]["median"] - 300) <= 15
    assert abs(stats["B"]["tls"]["median"] - 450) <= 25
    assert stats["C"] == {"reads": 280, "reference": "unmapped"}
    for s, ref in (("A", "chrA"), ("B", "chrZ")):
        recs = read_bam(tout / s / "sorted.bam")[2]
        assert len(recs) == 280 and {r.qname[0] for r in recs} == {s}
        mapped = [r for r in recs if r.is_mapped]
        assert len(mapped) >= 0.95 * len(recs)
        assert {r.rname for r in mapped} <= {ref, "chrB"} \
            and ref in {r.rname for r in mapped}
    c = read_bam(tout / "C" / "sorted.bam")[2]
    assert len(c) == 280 and not any(r.is_mapped for r in c)
    assert sorted(set(_qnames(tout / "unknown" / "sorted.bam"))) == \
        sorted(f"u{i}" for i in range(40))


def test_per_barcode_rebatcher_equals_jax():
    """Rows picked from padded batches rebatch into full batches and one
    padded tail, as in JAX, for lazy and list names."""
    rng = np.random.default_rng(2)
    outs = []
    for mod, fq in ((per_barcode, fastq), (jper_barcode, jfastq)):
        rb = mod._Rebatcher(16)
        got = []
        for k in range(5):
            names = [f"r{k}_{i}" for i in range(10)]
            b = fq.pad_batch(fq.ReadBatch(
                fq.LazyNames.from_list(names) if k % 2 else names,
                rng.integers(0, 5, (10, 12)).astype(np.uint8),
                rng.integers(0, 41, (10, 12)).astype(np.uint8),
                np.full(10, 12, np.int32)), 12)
            rows = np.nonzero(rng.random(10) < 0.7)[0]
            got += list(rb.add(b, rows))
        got += list(rb.flush())
        outs.append([(list(b.names), b.bases.tolist(), b.lengths.tolist())
                     for b in got])
        rng = np.random.default_rng(2)
    assert outs[0] == outs[1]
    assert len(outs[0]) >= 2 and outs[0][-1][0][-1].startswith("__pad")
