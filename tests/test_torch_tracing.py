"""Stage spans of the port (`utils/tracing.span`): accumulation into the
current collector, nesting, the exception path, the profiler's ranges
(opened only while a profiler collects), the keys a paired, single-end
and two-group batch fill on the CPU, answers unchanged under the
profiler, and an import of the module that loads no torch.  The test
marked `cuda` runs on the card
(`python -m pytest --noconftest tests/test_torch_tracing.py -q`) and
skips elsewhere."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from isaac_aligner_tpu_torch import synthetic
from isaac_aligner_tpu_torch.aligner import Aligner, PairedAligner
from isaac_aligner_tpu_torch.align.pairs import TlsStatic
from isaac_aligner_tpu_torch.index.build import build_index
from isaac_aligner_tpu_torch.io.fasta import genome_from_sequences
from isaac_aligner_tpu_torch.io.fastq import ReadBatch
from isaac_aligner_tpu_torch.parallel.multi_index import \
    MultiIndexPairedAligner
from isaac_aligner_tpu_torch.utils import tracing

REPO = Path(__file__).resolve().parents[1]
L = 100
TLS = TlsStatic(min=200, max=400, mate_min=200, mate_max=400, best0=1,
                best1=6)
POLISH_KEYS = ("polish.clip", "polish.rescue", "polish.gapped",
               "polish.gapped.windows", "polish.gapped.kernel",
               "polish.gapped.traceback", "polish.indel")
DEVICE_KEYS = ("device.seed", "device.score", "device.clip", "device.rescue")


def _genome(rng, names, length):
    return genome_from_sequences([
        (n, "".join("ACGT"[i] for i in rng.integers(0, 4, length)))
        for n in names])


@pytest.fixture(scope="module")
def two_groups():
    """Two 20 kbp contig-group indexes and 64 pairs from each: 20% of
    the ends carry an indel (banded SW) and 15% of read 2s are damaged
    past their seeds (the rescue)."""
    rng = np.random.default_rng(13)
    genomes = [_genome(rng, ["gA"], 20_000), _genome(rng, ["gB"], 20_000)]
    indexes = [build_index(g, seed_len=32, device="cpu") for g in genomes]
    b1, b2 = [], []
    for g in genomes:
        p = synthetic.make_pairs(rng, g.codes, 64, read_len=L,
                                 indel_frac=0.2, damaged_frac=0.15,
                                 far_frac=0.0)
        b1.append(p.bases1)
        b2.append(p.bases2)
    return indexes, np.concatenate(b1), np.concatenate(b2)


def _batches(bases1, bases2):
    n = bases1.shape[0]
    names = [f"t{i}" for i in range(n)]
    quals = np.full((n, L), 35, np.uint8)
    quals[::7, -15:] = 8                     # low-quality tails to trim
    lengths = np.full(n, L, np.int32)
    return (ReadBatch(names, bases1.copy(), quals.copy(), lengths),
            ReadBatch(names, bases2.copy(), quals.copy(), lengths))


def _paired(index):
    al = PairedAligner.create(index, read_len=L, device="cpu")
    al.tls = TLS
    return al


def test_span_accumulates_nests_and_adds_up():
    t: dict = {}
    with tracing.collect(t):
        for _ in range(3):
            with tracing.span("outer"):
                with tracing.span("outer.inner"):
                    sum(range(20_000))
    assert set(t) == {"outer", "outer.inner"}
    assert 0 < t["outer.inner"] <= t["outer"]


def test_span_records_when_the_block_raises():
    t: dict = {}
    with tracing.collect(t):
        with pytest.raises(KeyError):
            with tracing.span("failing"):
                raise KeyError("x")
    assert t["failing"] >= 0
    # the collector ends with its block
    with tracing.span("after"):
        pass
    assert "after" not in t


def test_span_without_collector_adds_nothing():
    with tracing.span("alone"):
        pass
    inner: dict = {}
    outer: dict = {}
    with tracing.collect(outer):
        with tracing.collect(inner), tracing.span("a"):
            pass
        with tracing.span("b"):
            pass
    assert set(inner) == {"a"} and set(outer) == {"b"}


def test_no_profiler_range_while_no_profiler_collects(monkeypatch):
    entered = []

    class Range:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            entered.append(self.name)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", Range)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Range)
    with tracing.span("quiet"):
        pass
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("traced"):
            pass
    assert entered == ["isaac:traced"]


def test_profiler_ranges_are_host_records_named_isaac():
    t: dict = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.collect(t), tracing.span("stage"):
            with tracing.span("stage.part"):
                torch.ones(4) + 1
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    assert {"isaac:stage", "isaac:stage.part"} <= set(events)
    # not user annotations: the profiler draws no copy of them on a
    # device's timeline
    assert not events["isaac:stage"].is_user_annotation()
    assert set(t) == {"stage", "stage.part"}
    assert not any(n.startswith(tracing.PROFILER_PREFIX + "bench:")
                   or n.startswith("bench:") for n in events)


def test_paired_batch_fills_every_stage(two_groups):
    indexes, bases1, bases2 = two_groups
    al = _paired(indexes[0])
    al.align_batch_arrays(*_batches(bases1[:64], bases2[:64]))
    t = al.timings
    for key in ("dispatch", "fetch", "fetch.wait", "fetch.copy", "polish",
                "stats") + POLISH_KEYS + DEVICE_KEYS:
        assert key in t, key
    assert al.sw_pairs > 0 and al.rescue_calls > 0
    # no wait on the CPU; the wait and the copies make the fetch
    assert t["fetch.wait"] == pytest.approx(0.0, abs=1e-4)
    assert t["fetch.wait"] + t["fetch.copy"] == pytest.approx(
        t["fetch"], rel=0.01, abs=1e-4)
    gapped = sum(t["polish.gapped." + k]
                 for k in ("windows", "kernel", "traceback"))
    assert gapped <= t["polish.gapped"]
    assert sum(t[k] for k in ("polish.clip", "polish.rescue",
                              "polish.gapped", "polish.indel")) \
        <= t["polish"]
    assert not any(k.startswith("bench:") for k in t)
    al.align_to_sam(*_batches(bases1[:8], bases2[:8]))
    assert "records" in al.timings


def test_single_end_batch_fills_its_stages(two_groups):
    indexes, bases1, _ = two_groups
    al = Aligner.create(indexes[0], read_len=L, device="cpu")
    al.align_to_sam(_batches(bases1[:64], bases1[:64])[0])
    assert {"upload", "dispatch", "fetch", "fetch.wait", "fetch.copy",
            "polish", "polish.clip", "polish.gapped", "polish.indel",
            "stats", "records", "device.seed", "device.score",
            "device.clip"} <= set(al.timings)
    assert "device.rescue" not in al.timings


def test_answers_equal_with_the_profiler_on_and_off(two_groups):
    indexes, bases1, bases2 = two_groups
    al = _paired(indexes[0])
    batches = _batches(bases1[:64], bases2[:64])
    off = al.align_batch_arrays(*batches)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = al.align_batch_arrays(*batches)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"isaac:polish.gapped.kernel", "isaac:device.rescue",
            "isaac:fetch.copy"} <= names
    assert off.keys() == on.keys()
    for k in off:
        if isinstance(off[k], np.ndarray):
            np.testing.assert_array_equal(off[k], on[k], err_msg=k)
        else:
            assert off[k] == on[k], k


def test_two_groups_fill_merge(two_groups):
    indexes, bases1, bases2 = two_groups
    al = MultiIndexPairedAligner.create(indexes, read_len=L, device="cpu")
    al.tls = TLS
    al.align_batch_arrays(*_batches(bases1, bases2))
    t = al.timings
    assert t["merge"] > 0 and al.own_timings.keys() == {"merge"}
    # the groups' own stages sum into the driver's timings
    assert t["polish"] == pytest.approx(
        sum(a.timings["polish"] for a in al.aligners))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the banded SW kernel has no CPU "
                    "mode")
    return "cuda"


@pytest.mark.cuda
def test_card_batch_under_the_profiler(two_groups, cuda_device):
    """On the card: the wait for the card is its own span, the program's
    ranges stay off the device's timeline, and the answers are the same
    with the profiler on and off."""
    indexes, bases1, bases2 = two_groups
    al = PairedAligner.create(indexes[0], read_len=L, device=cuda_device)
    al.tls = TLS
    batches = _batches(bases1[:64], bases2[:64])
    off = al.align_batch_arrays(*batches)
    assert al.timings["fetch.wait"] > 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        on = al.align_batch_arrays(*batches)
    events = list(prof.profiler.kineto_results.events())
    assert "isaac:polish.gapped.kernel" in {e.name() for e in events}
    assert not [e for e in events if e.device_type().name == "CUDA"
                and e.name().startswith(tracing.PROFILER_PREFIX)]
    for k in off:
        if isinstance(off[k], np.ndarray):
            np.testing.assert_array_equal(off[k], on[k], err_msg=k)
        else:
            assert off[k] == on[k], k


def test_tracing_imports_no_torch():
    code = ("import sys\n"
            "import isaac_aligner_tpu_torch.utils.tracing as t\n"
            "d = {}\n"
            "with t.collect(d), t.span('x'):\n"
            "    pass\n"
            "assert 'torch' not in sys.modules and 'x' in d\n"
            "print('OK')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr
