"""Port's single-end AlignWorkflow vs the JAX AlignWorkflow, FASTQ to sorted
BAM on the CPU: sorted.bam, .bai and .md5 byte-equal in every case, equal
stats counts, resume, batch-size invariance, the CLI, the refusals of what
is not ported, and the default device."""

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
    base = dict(reference=str(d / "ref.fa"), output_dir=str(out),
                fastq1=str(d / "r1.fq"), batch_size=BATCH)
    if mod is wf:
        base["device"] = "cpu"
    return mod.WorkflowOptions(**{**base, **kw})


CASES = {
    "defaults": ({}, {}),
    "several_bins": ({"records_per_bin": 40}, {}),
    "unaligned_front": ({"keep_unaligned": "front"}, {}),
    "unaligned_discard": ({"keep_unaligned": "discard"}, {}),
    "realign_no": ({"realign_gaps": "no"}, {}),
    "in_process": ({}, {"ISAAC_TPU_OUTPUT_PROC": "0"}),
}


@pytest.fixture(scope="module")
def ran(inputs, tmp_path_factory):
    """case -> (JAX output dir, port output dir), each run once."""
    done: dict = {}

    def get(case: str):
        if case not in done:
            kw, env = CASES[case]
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


@pytest.mark.parametrize("kw,item", [
    ({"run_folder": "run"}, 8),
    ({"bam_input": "in.bam"}, 9),
    ({"sample_sheet": "sheet.csv"}, 10),
    ({"devices": 2}, 7),
    ({"dist_processes": 2}, 7),
    ({"reference": "a.fa,b.fa"}, 5),
], ids=["run_folder", "bam_input", "sample_sheet", "devices2",
        "multi_host", "grouped_reference"])
def test_unported_options_raise(inputs, tmp_path, kw, item):
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP queue A item {item}"):
        wf.AlignWorkflow(_opts(wf, inputs, tmp_path / "out", **kw))
    assert not (tmp_path / "out").exists()


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
    converted batch, imports no torch."""
    script = f"""
import queue, sys
import numpy as np
from isaac_aligner_tpu_torch.workflow import output_proc
from isaac_aligner_tpu_torch.io.fastq import LazyNames
names = LazyNames.from_list(["a", "b", "__pad0"])
res = {{"aligned": np.array([1, 0, 0], bool),
        "reverse": np.array([1, 0, 0], bool),
        "start": np.array([120, 0, 0], np.int32),
        "mapq": np.array([60, 0, 0], np.int32),
        "edit_distance": np.array([1, 0, 0], np.int32),
        "cigar": ["2S8M", None, None]}}
bases = np.zeros((3, 10), np.uint8)
quals = np.full((3, 10), 30, np.uint8)
q, rq = queue.Queue(), queue.Queue()
q.put((0, 2, names.mat, names.lens, (bases, quals,
       np.array([10, 10, 0], np.int32)), None, res))
q.put(None)
output_proc._child_main(dict(
    bins_dir={str(tmp_path / 'bins')!r}, contig_offsets=np.array([0, 1000]),
    genome_bp=2000, n_bins=1, sample_cap=8, pre_sort=True, uniform=False,
    mapq_cap=60, mapq_threshold=0), q, rq)
status, out = rq.get()
assert status == "ok", out
assert out["stats"]["total_reads"] == 2 and out["stats"]["aligned"] == 1
assert "torch" not in sys.modules
print("OK")
"""
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "OK" in proc.stdout
    assert list((tmp_path / "bins").glob("bin_00000/chunk_*.cols"))
