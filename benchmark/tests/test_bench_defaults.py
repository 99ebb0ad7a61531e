"""The cell at `isaac-align`'s defaults (`grch38_cut128.pe150.lib`) on the
CPU at a small size: a sound run comes out correct, with the timed path
broken underneath or at the control's precision it does not, and the
reference of the default clipping passes (`benchmark/reference/clips.py`,
through `clipcheck.py`) finds every kept row as the program clipped it."""

import pytest

import clipcheck
import harness
import run

CELL = "grch38_cut128.pe150.lib"
SCALE = {
    "config.genome.contigs": [{"name": f"chr{i}", "length": 200_000}
                              for i in (1, 2, 3)]
    + [{"name": "chrM", "length": 16_569}],
    "config.index.group_limit": 450_000,
    "traffic.pairs": 4096, "traffic.library.far_min": 100_000,
    "traffic.batch_pairs": 1024,
    "traffic.tls": {"batch": 1024, "batches": 2},
    "traffic.check.pairs_per_unit": 512,
}
SEED = 2**31 + 1501


def cell() -> dict:
    return harness.find_cell(harness.benchmark_spec(), CELL)


@pytest.fixture(scope="module", autouse=True)
def index_built():
    """The scaled configuration's index, built once under a lock: test
    processes that share the cache directory would otherwise build it at
    once and remove each other's half-built copy."""
    import fcntl

    import generator
    import program
    config = harness.find_config("grch38_cut128")
    for key, val in SCALE.items():
        block, name = key.split(".", 1)
        if block == "config":
            *path, leaf = name.split(".")
            target = config
            for p in path:
                target = target[p]
            target[leaf] = val
    cache = harness.cache_dirs()["index"]
    cache.mkdir(parents=True, exist_ok=True)
    with open(cache / "defaults-tests.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        program.ensure_index(config, generator.make_genome(config["genome"]),
                             cache)


def readings(fault=None):
    out = run.run_cell(cell(), SEED, 0.5, False, device="cpu", fault=fault,
                       scale=SCALE)
    correct, checks = run.judge(out["checks"], run.limits_for(CELL))
    return correct, {k: v[0] for k, v in checks.items()}, out


def test_config_is_the_noclip_config_at_the_defaults():
    """The configuration differs from grch38_cut128_noclip's only by its
    name, source, deployment and the switches it leaves at the defaults."""
    new = harness.find_config("grch38_cut128")
    old = harness.find_config("grch38_cut128_noclip")
    for key in ("genome", "index", "workflow", "precision", "guarantees",
                "cut", "assumed", "reduced"):
        assert new[key] == old[key], key
    assert "options" not in new and "departures" not in new


def test_sound_run_is_correct_and_faults_are_not():
    correct, got, out = readings()
    assert correct, got
    assert out["window"]["units"] >= 1
    for fault, number in (("altered", "nm_wrong"),
                          ("stale", "misplaced_pct")):
        bad, worse, _ = readings(fault)
        assert not bad, worse
        assert worse[number] > run.limits_for(CELL).get(number, 0), worse
    bad, control, _ = readings(run.limits_for(CELL)["_control"])
    assert not bad, control
    assert control["log_prob_gap"] > run.limits_for(CELL)["log_prob_gap"] \
        > got["log_prob_gap"]


def test_kept_rows_equal_the_clip_reference():
    out = clipcheck.clip_check(cell(), SEED, 0.5, device="cpu", scale=SCALE)
    assert out["ends"] > 500
    assert out["bad"] == {}, out["first"]
    ref = out["reference"]
    assert ref["trimmed"] > 0 and ref["semialigned"] > 0 \
        and ref["overlap"] > 0, ref
    counters = out["counters"]
    assert all(counters[c] > 0 for c in ("trimmed_ends",
                                         "semialigned_clipped",
                                         "overlap_clipped")), counters


@pytest.mark.parametrize("name", ["clip_s_per_mread.lib",
                                  "indel_s_per_mread.lib"])
def test_new_metrics_read_spans_and_stay_silent_without(name):
    read = harness.metric_reader(name)
    stage = {"polish.clip.trim": 0.5, "polish.clip.semialigned": 0.25,
             "polish.clip.overlap": 0.25, "polish.indel": 2.0}
    got = read({"entry": "library", "reads": 2_000_000,
                "stage_seconds": stage})
    assert got == (0.5 if name.startswith("clip") else 1.0)
    assert read({"entry": "library", "reads": 2_000_000,
                 "stage_seconds": {"polish": 1.0}}) is None
    assert read({"entry": "workflow"}) is None


def test_fault_of_a_default_pass_reads_over_three_limits(monkeypatch):
    """`clipfaults.py`'s `trim_start_kept` (a reverse end's masked tail
    clipped without its start moving) reads `misplaced_pct` over three
    times the cell's limit, the reading the limit rests on."""
    import clipfaults
    import program
    monkeypatch.setattr(program, "planted", clipfaults.planted)
    bad, worse, _ = readings("trim_start_kept")
    assert not bad
    assert worse["misplaced_pct"] > 3 * run.limits_for(CELL)["misplaced_pct"]
