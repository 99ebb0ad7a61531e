"""Port's single-end AlignWorkflow vs the JAX AlignWorkflow, FASTQ to sorted
BAM on the CPU: sorted.bam, .bai and .md5 byte-equal in every case, equal
stats counts, resume, batch-size invariance, the CLI and its options, the
output process's child, and the default device.  Contig-group references
are in `tests/test_torch_groups.py`; run folders, BAM input and
demultiplexing in `tests/test_torch_bcl.py`, `tests/test_torch_bam_input.py`
and `tests/test_torch_demux.py`."""

import dataclasses
import json
import os
import subprocess
import sys
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest
import torch

from isaac_aligner_tpu.workflow import align as jwf
from isaac_aligner_tpu_torch import dna
from isaac_aligner_tpu_torch.io.bam import read_bam
from isaac_aligner_tpu_torch.workflow import align as wf

from test_torch_aligner import _indel_fixture

REPO = Path(__file__).resolve().parents[1]
BATCH = 128
OUTPUTS = ("sorted.bam", "sorted.bam.bai", "sorted.bam.md5")


def _deletion_sites(g: np.ndarray, n: int = 3):
    """(pos, length, tail) of the first `n` deletions, 1 kbp apart, that a
    read ending `tail` bases past the deletion aligns ungapped with 1..4
    mismatches and a matching last 5 bases: too few mismatches for the
    gapped polish and nothing for the semialigned clip, so only the Build
    phase's known-gap realignment can place the gap."""
    sites = []
    for q in range(300, g.size - 400):
        for k in (2, 3):
            for d in (8, 9, 10):
                ref, read = g[q:q + d], g[q + k:q + k + d]
                m = int((ref != read).sum())
                if (ref[-5:] == read[-5:]).all() and 1 <= m <= 4 and (
                        not sites or q - sites[-1][0] > 1000):
                    sites.append((q, k, d))
        if len(sites) == n:
            return sites
    raise AssertionError("no deletion sites found")


def workflow_reads():
    """(genome codes, [(name, bases, quals)]): the 64 reads of
    `_indel_fixture`, 8 exact copies of other reads under new names
    (duplicates), 3 deletions each read twice (once mid-read, where the
    gapped polish finds it, and once near the 3' end, where only the
    known-gap realignment does) and 4 all-N reads (unaligned)."""
    index, batch = _indel_fixture()
    g = index.genome.codes
    rows = list(zip(batch.names, batch.bases, batch.quals))
    for j, i in enumerate((8, 9, 10, 20, 30, 40, 50, 60)):
        rows.append((f"dup{j}", batch.bases[i], batch.quals[i]))
    q35 = np.full(100, 35, np.uint8)
    for j, (p, k, d) in enumerate(_deletion_sites(g)):
        rows.append((f"gap{j}", np.concatenate([g[p - 50:p],
                                                g[p + k:p + k + 50]]), q35))
        rows.append((f"near{j}", np.concatenate([g[p - 100 + d:p],
                                                 g[p + k:p + k + d]]), q35))
    for j in range(4):
        rows.append((f"allN{j}", np.full(100, 4, np.uint8),
                     np.full(100, 2, np.uint8)))
    return g, rows


def write_inputs(d: Path) -> Path:
    g, rows = workflow_reads()
    seq = dna.decode(g)
    (d / "ref.fa").write_text(
        ">chrI\n" + "\n".join(seq[i:i + 70]
                              for i in range(0, len(seq), 70)) + "\n")
    with open(d / "r1.fq", "w") as f:
        for name, bases, quals in rows:
            qual = (np.asarray(quals, np.uint8) + 33).tobytes().decode()
            f.write(f"@{name}\n{dna.decode(bases)}\n+\n{qual}\n")
    return d


@pytest.fixture(scope="module")
def inputs(tmp_path_factory) -> Path:
    return write_inputs(tmp_path_factory.mktemp("wf_in"))


@contextmanager
def _env(env: dict):
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _opts(mod, d: Path, out: Path, **kw):
    """Options of `mod`'s workflow on the inputs in `d`; a `reference` in
    `kw` names an entry of `d`."""
    if "reference" in kw:
        kw = {**kw, "reference": str(d / kw["reference"])}
    base = dict(reference=str(d / "ref.fa"), output_dir=str(out),
                fastq1=str(d / "r1.fq"), batch_size=BATCH)
    if mod is wf:
        base["device"] = "cpu"
    return mod.WorkflowOptions(**{**base, **kw})


_IN_PROCESS = {"ISAAC_TPU_OUTPUT_PROC": "0"}

CASES = {
    "defaults": ({}, {}),
    "several_bins": ({"records_per_bin": 40}, {}),
    "unaligned_front": ({"keep_unaligned": "front"}, {}),
    "unaligned_discard": ({"keep_unaligned": "discard"}, {}),
    "realign_no": ({"realign_gaps": "no"}, {}),
    "in_process": ({}, _IN_PROCESS),
    # 64-mer seeds over the FASTA's 32-mer index (extension check), and
    # against the port's `sort-reference -s 64` directory (four key planes)
    "seed64_fasta": ({"seed_len": 64}, _IN_PROCESS),
    "seed64_index": ({"reference": "idx64", "seed_len": 64}, _IN_PROCESS),
    "neighbors": ({"neighborhood_size_threshold": 100}, _IN_PROCESS),
}


def _sort_reference_64(d: Path) -> None:
    """d/idx64: the port's sort-reference -s 64 of d/ref.fa, annotated on
    the CPU."""
    from isaac_aligner_tpu_torch.cli import main as cli
    if not (d / "idx64").exists():
        assert cli(["sort-reference", "-g", str(d / "ref.fa"), "-o",
                    str(d / "idx64"), "-s", "64", "--device", "cpu"]) == 0


@pytest.fixture(scope="module")
def ran(inputs, tmp_path_factory):
    """case -> (JAX output dir, port output dir), each run once."""
    done: dict = {}

    def get(case: str):
        if case not in done:
            kw, env = CASES[case]
            if kw.get("reference") == "idx64":
                _sort_reference_64(inputs)
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
                                "mapq_hist")},
            {k: build[k] for k in ("records", "duplicates", "realigned",
                                   "bins")})


@pytest.mark.parametrize("case", list(CASES))
def test_bam_equals_jax_workflow(case, ran):
    jout, tout = ran(case)
    for name in OUTPUTS:
        assert (tout / name).read_bytes() == (jout / name).read_bytes(), name
    assert _stats(tout) == _stats(jout)
    ms, build = _stats(jout)
    assert ms["total_reads"] - ms["aligned"] >= 4        # the all-N reads
    assert build["records"] == (ms["aligned"] if case == "unaligned_discard"
                                else ms["total_reads"])
    if case == "defaults":
        # both Build-phase paths really ran
        assert build["duplicates"] > 0 and build["realigned"] > 0
    if case == "several_bins":
        assert build["bins"] > 1
    if case == "realign_no":
        assert build["realigned"] == 0
    if case.startswith("seed64"):
        assert ms["aligned"] >= 0.6 * ms["total_reads"]


def test_resume_gives_the_same_bytes(inputs, ran, tmp_path):
    jout, _ = ran("defaults")
    out = tmp_path / "resumed"
    first = wf.AlignWorkflow(_opts(wf, inputs, out))
    first.run(stop_at="AlignDone")
    assert first.state == "AlignDone" and not (out / "sorted.bam").exists()
    assert list((out / "Temp" / "bins").glob("bin_*/chunk_*.cols"))
    assert (out / "Temp" / "bins" / "boundaries.json").exists()
    second = wf.AlignWorkflow(_opts(wf, inputs, out))
    second.run(resume=True)
    assert second.state == "BamDone"
    for name in OUTPUTS:
        assert (out / name).read_bytes() == (jout / name).read_bytes(), name


def _records(path: Path):
    return [(r.qname, r.flag, r.rname, r.pos, r.mapq, r.cigar,
             sorted(r.tags.items())) for r in read_bam(path)[2]]


def test_batch_size_does_not_change_records(inputs, ran, tmp_path):
    _, tout = ran("defaults")
    wf.AlignWorkflow(_opts(wf, inputs, tmp_path / "b32",
                           batch_size=32)).run()
    assert _records(tmp_path / "b32" / "sorted.bam") == \
        _records(tout / "sorted.bam")


def test_cli_writes_the_same_bam(inputs, ran, tmp_path):
    jout, _ = ran("defaults")
    out = tmp_path / "cli"
    proc = subprocess.run(
        [sys.executable, "-m", "isaac_aligner_tpu_torch", "align",
         "-r", str(inputs / "ref.fa"), "-1", str(inputs / "r1.fq"),
         "-o", str(out), "--batch-size", str(BATCH), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "BamDone" in proc.stdout
    for name in OUTPUTS:
        assert (out / name).read_bytes() == (jout / name).read_bytes(), name


def test_options_match_jax_plus_device():
    jfields = [(f.name, f.default) for f in dataclasses.fields(jwf.WorkflowOptions)]
    fields = [(f.name, f.default) for f in dataclasses.fields(wf.WorkflowOptions)]
    assert fields == jfields + [("device", "cuda")]
    assert wf.STATES == jwf.STATES


class _Parsed(Exception):
    pass


def _align_options(cli_main, monkeypatch) -> dict:
    """{option strings: (default, choices, nargs, action kind)} of a
    CLI's `align` subcommand."""
    import argparse

    def grab(self, args=None, namespace=None):
        raise _Parsed(self)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed) as e:
        cli_main(["align"])
    monkeypatch.undo()
    sub = next(a for a in e.value.args[0]._actions
               if isinstance(a, argparse._SubParsersAction))
    return {tuple(a.option_strings): (a.default, a.choices, a.nargs,
                                      type(a).__name__)
            for a in sub.choices["align"]._actions}


def test_align_cli_options_match_jax_plus_device(monkeypatch):
    from isaac_aligner_tpu.cli import main as jcli
    from isaac_aligner_tpu_torch.cli import main as cli

    want = _align_options(jcli, monkeypatch)
    got = _align_options(cli, monkeypatch)
    assert got.pop(("--device",))[0] == "cuda"
    assert got == want
    for opt in (("-b", "--bam"), ("--run-folder",), ("--sample-sheet",),
                ("--per-tile-tls",), ("--help-md",)):
        assert opt in got


def test_no_input_raises_as_in_jax(inputs, tmp_path):
    errors = []
    for mod in (jwf, wf):
        kw = {"device": "cpu"} if mod is wf else {}
        with pytest.raises(ValueError) as e:
            mod.AlignWorkflow(mod.WorkflowOptions(
                reference=str(inputs / "ref.fa"),
                output_dir=str(tmp_path / mod.__name__), **kw)).run()
        errors.append(str(e.value))
    assert errors[0] == errors[1] == "need --fastq1, --run-folder or --bam input"


def test_default_device_is_the_card(inputs, tmp_path):
    opts = wf.WorkflowOptions(reference=str(inputs / "ref.fa"),
                              output_dir=str(tmp_path / "out"),
                              fastq1=str(inputs / "r1.fq"))
    assert opts.device == "cuda"
    if torch.cuda.is_available():
        return
    run = wf.AlignWorkflow(opts)
    with pytest.raises(RuntimeError, match="cuda"):
        run.run()
    assert run.state == "Start"
    assert not (tmp_path / "out" / "sorted.bam").exists()


def test_output_process_child_needs_no_torch(tmp_path):
    """The spawned child's code path, run in a fresh interpreter on one
    converted, demultiplexed run-folder batch (barcodes resolved against a
    sample sheet, RG, BC and ZX/ZY columns), imports no torch."""
    (tmp_path / "sheet.csv").write_text("barcode,sample\nACGTACGT,s1\n")
    script = f"""
import queue, sys
import numpy as np
from isaac_aligner_tpu_torch.workflow import output_proc
from isaac_aligner_tpu_torch.io.fastq import LazyNames
from isaac_aligner_tpu_torch.demultiplexing import parse_sample_sheet
names = LazyNames.from_list(["SIM:1:FC:1:1101:1010:2020",
                             "SIM:1:FC:1:1101:1030:2040", "__pad0"])
barcodes = np.array([[0, 1, 2, 3, 0, 1, 2, 3], [3, 3, 3, 3, 3, 3, 3, 3]],
                    np.uint8)
res = {{"aligned": np.array([1, 0, 0], bool),
        "reverse": np.array([1, 0, 0], bool),
        "start": np.array([120, 0, 0], np.int32),
        "mapq": np.array([60, 0, 0], np.int32),
        "edit_distance": np.array([1, 0, 0], np.int32),
        "cigar": ["2S8M", None, None]}}
bases = np.zeros((3, 10), np.uint8)
quals = np.full((3, 10), 30, np.uint8)
q, rq = queue.Queue(), queue.Queue()
q.put((0, 2, names.mat, names.lens, barcodes, (bases, quals,
       np.array([10, 10, 0], np.int32)), None, res))
q.put(None)
output_proc._child_main(dict(
    bins_dir={str(tmp_path / 'bins')!r}, contig_offsets=np.array([0, 1000]),
    genome_bp=2000, n_bins=1, sample_cap=8, pre_sort=True, uniform=False,
    mapq_cap=60, mapq_threshold=0, rg_names=("s1", "unknown"),
    specs=parse_sample_sheet({str(tmp_path / 'sheet.csv')!r}),
    spec_to_name=np.array([0], np.int32), unknown=1, want_bc=True,
    want_zxzy=True, run_folder=True, barcode_mismatches=1), q, rq)
status, out = rq.get()
assert status == "ok", out
assert out["stats"]["total_reads"] == 2 and out["stats"]["aligned"] == 1
assert out["demux_counts"] == [1, 1], out["demux_counts"]
assert {{tuple(k.split("|")[:3]) for k in out["per_tile"]}} == \
    {{("1", "1101", "s1"), ("1", "1101", "unknown")}}, out["per_tile"]
assert "torch" not in sys.modules
print("OK")
"""
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "OK" in proc.stdout
    chunks = list((tmp_path / "bins").glob("bin_00000/chunk_*.cols"))
    assert chunks
    from isaac_aligner_tpu_torch.build.storage import BinnedFragmentStore
    fb = BinnedFragmentStore.load_bin(chunks[0].parent)
    assert fb.rg_names == ("s1", "unknown") and fb.rg.tolist() == [0]
    assert (fb.zx.tolist(), fb.zy.tolist()) == ([1010], [2020])
    assert bytes(fb.bc[0][:8]) == b"ACGTACGT"
