"""The s/Mread and roofline arithmetic, and the no-JAX check."""

import math

import pytest

import harness
import roofline

H100 = roofline.PEAKS["NVIDIA H100 80GB HBM3"]


def test_s_per_mread():
    assert harness.s_per_mread(2.5, 5_000_000) == pytest.approx(0.5)
    assert harness.s_per_mread(None, 10) is None
    assert harness.s_per_mread(1.0, 0) is None


@pytest.mark.parametrize("n,l", [(896, 100), (1239, 100), (8192, 100)])
def test_banded_sw_counts_at_the_launch_shapes(n, l):
    ops, nbytes = roofline.banded_sw_counts(n, l)
    # per band cell: G (2 max + 1 add) and F (3 adds + 2 max) on all 16
    # diagonals, E (3 adds + 2 max) on 15
    assert ops == n * l * (8 * 16 + 5 * 15) == n * l * 203
    tb_words = math.ceil(l / 5) * 16
    assert nbytes == n * l + n * (l + 15) + 4 * n * 16 + 4 * n * tb_words
    least, bound = roofline.least_seconds([(n, l)], H100)
    assert bound == "operations"
    assert least == pytest.approx(ops / 33.5e12)


def test_roofline_share_of_the_measured_time():
    # 896 x 100 at 0.014740 ms a launch (PERF.md's kernel table, PR 8 B)
    pct, bound = roofline.roofline_pct([(896, 100)] * 10, 10 * 14.740e-6, H100)
    assert bound == "operations"
    assert pct == pytest.approx(100 * 896 * 100 * 203 / 33.5e12 / 14.740e-6)
    assert 3.0 < pct < 4.0
    assert roofline.roofline_pct([], 1.0, H100) == (None, None)
    assert roofline.roofline_pct([(896, 100)], 0.0, H100) == (None, None)
    assert roofline.roofline_pct([(896, 100)], 1.0, None) == (None, None)


def test_bytes_bound_when_operations_are_few():
    least, bound = roofline.least_seconds([(10, 1)], {"f32_lane_ops": 1e18,
                                                      "hbm_bytes_per_s": 1.0})
    assert bound == "bytes"
    assert least == roofline.banded_sw_counts(10, 1)[1]


@pytest.mark.parametrize("loaded,bad", [
    ({"isaac_aligner_tpu_torch": 1, "isaac_aligner_tpu_torch.aligner": 1},
     []),
    ({"isaac_aligner_tpu": 1}, ["isaac_aligner_tpu"]),
    ({"isaac_aligner_tpu.ops.sw": 1}, ["isaac_aligner_tpu"]),
    ({"jax.numpy": 1, "jaxlib.xla_client": 1}, ["jax", "jaxlib"]),
    ({"flax": 1, "jaxtyping": 1, "numpy": 1}, ["flax"]),
    ({"jax": None}, []),
])
def test_forbidden_modules_by_whole_top_level_name(loaded, bad):
    assert harness.forbidden_loaded(loaded) == bad


def test_the_harness_loads_no_jax():
    import subprocess
    import sys
    code = ("import sys; sys.path[:0] = [%r, %r]; import run, program, "
            "generator, devtrace, roofline, control; "
            "from reference import judge, bamfile; "
            "from entries import workflow, library; "
            "import isaac_aligner_tpu_torch.workflow.align, "
            "isaac_aligner_tpu_torch.parallel.multi_index; "
            "import harness; print(harness.forbidden_loaded())"
            % (str(harness.HERE), str(harness.ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]"


def test_trace_reduction():
    """Busy time is the union of device events, the benchmark's spans are
    no device work, and idle gaps (edges included) are named by the
    innermost span open at their middle."""
    import enum
    import types

    import devtrace

    class Dev(enum.Enum):
        CPU = 0
        CUDA = 1

    def ev(name, dev, start, dur):
        return types.SimpleNamespace(
            name=lambda: name, device_type=lambda: dev,
            start_ns=lambda: start, duration_ns=lambda: dur)

    events = [ev("bench:workflow.Start", Dev.CPU, 0, 100),
              ev("bench:aligner.fetch_polish", Dev.CPU, 10, 30),
              ev("bench:aligner.fetch_polish", Dev.CUDA, 10, 30),
              ev("k1", Dev.CUDA, 12, 3), ev("k2", Dev.CUDA, 14, 4),
              ev("k3", Dev.CUDA, 50, 10)]
    r = devtrace.reduce_events(events, 100e-9, edges=(0, 100))
    assert r["busy_s"] == pytest.approx(16e-9)
    assert r["window_s"] == 100e-9
    assert [k for k, _ in r["device_ops"]] == ["k3", "k2", "k1"]
    # gaps [60, 100), [18, 50) and [0, 12), named at 80, 34 and 6
    assert r["idle_gaps"] == [["workflow.Start", pytest.approx(40e-9)],
                              ["aligner.fetch_polish", pytest.approx(32e-9)],
                              ["workflow.Start", pytest.approx(12e-9)]]
