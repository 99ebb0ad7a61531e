"""Port's multi-process workflow on the CPU: scripts/torch_multihost_dryrun.py
runs two gloo processes over scripts/multihost_dryrun.py's 80-pair
fixture; their BAM equals the port's single-process run and the JAX
package's single-process `uniform_bins` run, and their merged stats
counts equal the single-process ones.  The JAX package's own two-process
run counts its seed tallies twice (ROADMAP §C3), which the port does not
copy."""

import importlib.util
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from isaac_aligner_tpu.workflow import align as jwf

REPO = Path(__file__).resolve().parents[1]
SCRIPT = REPO / "scripts" / "torch_multihost_dryrun.py"
OUTPUTS = ("sorted.bam", "sorted.bam.bai", "sorted.bam.md5")
#: the JAX run's extra all-pad batch: 16 rows, 4 pass-1 seeds an end
#: (80 bp reads, 32-mer seeds at 0 and 48, both strands), two ends
PAD_ROWS, PAD_SEEDS = 16, 16 * 4 * 2


def _finder(out: Path) -> dict:
    st = json.loads((out / "Temp" / "AlignerState.json").read_text())
    return {k: v for k, v in st["stats"]["match_finder"].items()
            if isinstance(v, int)}


@pytest.fixture(scope="module")
def port_run(tmp_path_factory) -> Path:
    out = tmp_path_factory.mktemp("torch_mh")
    proc = subprocess.run([sys.executable, str(SCRIPT), "--device", "cpu",
                           "--out", str(out)], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    result = json.loads([ln for ln in proc.stdout.splitlines()
                         if ln.startswith('{"byte_identical"')][-1])
    assert result["byte_identical"] and result["counts_equal"], result
    assert sorted(json.loads(ln)["process"] for ln in proc.stdout.splitlines()
                  if ln.startswith('{"process"')) == [0, 1]
    return out


def test_two_processes_equal_single_process_and_jax(port_run):
    """The two-process BAM, .bai and .md5 equal the port's single-process
    run and the JAX package's single-process uniform_bins run; the
    merged counts equal the single-process ones."""
    out = port_run
    jwf.AlignWorkflow(jwf.WorkflowOptions(
        reference=str(out / "ref.fa"), fastq1=str(out / "r1.fq"),
        fastq2=str(out / "r2.fq"), output_dir=str(out / "jax1"),
        batch_size=16, records_per_bin=48, tls_batches=2,
        uniform_bins=True)).run()
    for name in OUTPUTS:
        got = (out / "outN" / name).read_bytes()
        assert got == (out / "out1" / name).read_bytes(), name
        assert got == (out / "jax1" / name).read_bytes(), name
    ms = [json.loads((out / d / "Stats" / "MatchSelectorStats.json")
                     .read_text()) for d in ("out1", "outN", "jax1")]
    for k in ("total_reads", "aligned", "perfect", "proper_pairs",
              "mapq_hist"):
        assert ms[0][k] == ms[1][k] == ms[2][k], k
    assert ms[1]["total_reads"] == 160
    assert _finder(out / "outN") == _finder(out / "out1")
    assert _finder(out / "out1")["seeds_no_match"] > 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_jax_two_processes_count_seed_tallies_twice(port_run, tmp_path):
    """ROADMAP §C3: the JAX package's two-process run (its own dry run's
    children, on a free port) psums the seed tallies over the global data
    axis, then sums them over the hosts again, and its ragged tail's
    all-pad batch adds its rows: each count is 2 x (single-process count
    + the pad batch's).  The BAM stays byte-equal; the port's
    two-process counts equal its single-process ones."""
    spec = importlib.util.spec_from_file_location(
        "jax_mh_dryrun", REPO / "scripts" / "multihost_dryrun.py")
    dry = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(dry)
    dry._make_fixture(tmp_path)
    jwf.AlignWorkflow(jwf.WorkflowOptions(
        output_dir=str(tmp_path / "out1"), uniform_bins=True,
        **dry._base_opts(tmp_path))).run()
    child = (f"import importlib.util, sys; sys.path.insert(0, {str(REPO)!r})\n"
             f"spec = importlib.util.spec_from_file_location('d', "
             f"{str(REPO / 'scripts' / 'multihost_dryrun.py')!r})\n"
             f"m = importlib.util.module_from_spec(spec)\n"
             f"spec.loader.exec_module(m)\n"
             f"m.PORT = {_free_port()}\nm.child_main()\n")
    env = {**os.environ, "ISAAC_MH_TMP": str(tmp_path)}
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen([sys.executable, "-c", child],
                              env={**env, "ISAAC_TPU_DIST_PROCID": str(p)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for p in range(2)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), \
        "\n".join(x[-2000:] for x in logs)
    assert (tmp_path / "outN" / "sorted.bam").read_bytes() == \
        (tmp_path / "out1" / "sorted.bam").read_bytes()
    one, two = _finder(tmp_path / "out1"), _finder(tmp_path / "outN")
    b2 = round(PAD_ROWS * 0.25)
    pad = {"seeds_no_match": PAD_SEEDS, "pass2_reads": 2 * PAD_ROWS,
           "pass2_dropped": 2 * (PAD_ROWS - b2), "seeds_too_many": 0}
    for k, v in pad.items():
        assert two[k] == 2 * (one[k] + v), (k, one, two)
    # the same fixture through the port: counted once
    assert (port_run / "r1.fq").read_bytes() == \
        (tmp_path / "r1.fq").read_bytes()
    assert _finder(port_run / "outN")["seeds_no_match"] \
        == one["seeds_no_match"] != two["seeds_no_match"]


def test_two_processes_of_two_devices(port_run, tmp_path):
    """--devices 2: the single process runs the SPMD drivers over a
    two-entry mesh and collective dedup, each of the two processes the
    multi-process drivers over its own two-entry local mesh; their BAM
    equals each other's and the single-device runs'."""
    proc = subprocess.run([sys.executable, str(SCRIPT), "--device", "cpu",
                           "--devices", "2", "--out", str(tmp_path)],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    result = json.loads([ln for ln in proc.stdout.splitlines()
                         if ln.startswith('{"byte_identical"')][-1])
    assert result["byte_identical"] and result["counts_equal"], result
    assert result["devices"] == 2
    for name in OUTPUTS:
        assert (tmp_path / "outN" / name).read_bytes() == \
            (port_run / "out1" / name).read_bytes(), name
    assert _finder(tmp_path / "outN") == _finder(port_run / "out1")
