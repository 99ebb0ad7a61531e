"""The program's spans as the benchmark reads them: the readers of the
span metrics (None on a record of a program without the spans), and
`spantrace.reduce_spans` (device time by the span that launched it, idle
time by the span open on the host, annotations no device work)."""

import enum
import types

import pytest

import harness
import spantrace

SPAN_METRICS = {"fetch_wait_s_per_mread.lib": "fetch.wait",
                "rescue_s_per_mread.lib": "polish.rescue",
                "gapped_kernel_s_per_mread.lib": "polish.gapped.kernel",
                "traceback_s_per_mread.lib": "polish.gapped.traceback",
                "merge_s_per_mread.lib": "merge"}


class Dev(enum.Enum):
    CPU = 0
    CUDA = 1


def ev(name, dev, start, dur, corr=0, user=False, tid=1):
    return types.SimpleNamespace(
        name=lambda: name, device_type=lambda: dev, start_ns=lambda: start,
        duration_ns=lambda: dur, correlation_id=lambda: corr,
        start_thread_id=lambda: tid, is_user_annotation=lambda: user)


@pytest.mark.parametrize("name,key", sorted(SPAN_METRICS.items()))
def test_span_readers(name, key):
    read = harness.metric_reader(name)
    parent = {"entry": "library", "reads": 2_000_000,
              "stage_seconds": {"dispatch": 1.0, "fetch": 0.5,
                                "polish": 9.0}}
    assert read(parent) is None
    assert read({"entry": "workflow", "reads": 10}) is None
    spans = dict(parent, stage_seconds={**parent["stage_seconds"], key: 3.0})
    assert read(spans) == pytest.approx(1.5)


def test_span_metrics_in_benchmark_json():
    spec = harness.benchmark_spec()
    by_name = {m["name"]: m for m in spec["per_layer"]}
    for name in SPAN_METRICS:
        m = by_name[name]
        assert (m["source"], m["unit"], m["moves"]) == \
            ("program_span", "s/Mread", "align_reads_per_s")
    assert by_name["merge_s_per_mread.lib"]["workloads"] == \
        ["grch38_cut128_noclip.pe150.lib"]


def _trace(annotated: bool):
    """A window [0, 100) ns: span `polish` (10-60) holds `polish.gapped`
    (20-40); k1 is launched at 22 inside polish.gapped but runs at 45-50,
    when only `polish` is open; k2 is launched at 65, outside every span,
    and runs at 70-75; a copy launched at 12 runs at 14-16."""
    events = [ev("isaac:polish", Dev.CPU, 10, 50),
              ev("isaac:polish.gapped", Dev.CPU, 20, 20),
              ev("cudaLaunchKernel", Dev.CPU, 22, 1, corr=7),
              ev("cudaLaunchKernel", Dev.CPU, 65, 1, corr=9),
              ev("cudaMemcpyAsync", Dev.CPU, 12, 1, corr=5),
              ev("aten::mul", Dev.CPU, 21, 3, corr=7),
              ev("k1", Dev.CUDA, 45, 5, corr=7),
              ev("k2", Dev.CUDA, 70, 5, corr=9),
              ev("Memcpy HtoD (Pageable -> Device)", Dev.CUDA, 14, 2,
                 corr=5)]
    if annotated:
        # record_function ranges drawn on the device's timeline
        events += [ev("bench:aligner.fetch_polish", Dev.CUDA, 10, 60,
                      user=True),
                   ev("bench:aligner.fetch_polish", Dev.CPU, 5, 70,
                      user=True),
                   ev("isaac:polish", Dev.CUDA, 14, 36, user=True)]
    return events


@pytest.mark.parametrize("annotated", [False, True])
def test_reduce_spans(annotated):
    r = spantrace.reduce_spans(_trace(annotated), (0, 100))
    # by the launch, not by the overlap: k1 ran while only polish was open
    assert r["span_device_s"] == {"polish.gapped": pytest.approx(5e-9),
                                  "polish": pytest.approx(2e-9)}
    assert r["kernel_s"] == pytest.approx(10e-9)
    assert r["kernel_s_in_spans"] == pytest.approx(5e-9)
    # idle: [0,14) [16,45) [50,70) [75,100) = 88 ns of the window
    idle = r["idle_by_span"]
    assert sum(idle.values()) == pytest.approx(88e-9)
    assert idle == {"outside": pytest.approx((10 + 10 + 25) * 1e-9),
                    "polish": pytest.approx((4 + 4 + 5 + 10) * 1e-9),
                    "polish.gapped": pytest.approx(20e-9)}


def test_reduce_spans_without_annotation_flag():
    """Events without is_user_annotation: the two prefixes mark them."""
    events = []
    for e in _trace(True):
        flagless = types.SimpleNamespace(**{k: v for k, v in vars(e).items()
                                            if k != "is_user_annotation"})
        events.append(flagless)
    r = spantrace.reduce_spans(events, (0, 100))
    assert sum(r["idle_by_span"].values()) == pytest.approx(88e-9)


@pytest.mark.cuda
def test_program_spans_on_the_card(card):
    """On the card the program's ranges stay on the host's timeline, and
    the kernel launched inside a span is counted under it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from isaac_aligner_tpu_torch.utils import tracing
    x = torch.randn(1 << 20, device=card)
    torch.cuda.synchronize()
    t: dict = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with tracing.collect(t), tracing.span("stage"):
            (x * 2).sum()
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    assert not [e for e in events if e.device_type().name == "CUDA"
                and e.name().startswith("isaac:")]
    lo = min(int(e.start_ns()) for e in events)
    hi = max(int(e.start_ns()) + int(e.duration_ns()) for e in events)
    r = spantrace.reduce_spans(events, (lo, hi))
    assert r["span_device_s"]["stage"] > 0
    assert r["kernel_s_in_spans"] == pytest.approx(r["kernel_s"])
    assert set(t) == {"stage"}
