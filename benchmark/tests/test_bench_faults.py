"""Whole runs of each cell on the CPU at a small size, past the harness's
look for a card: sound, they come out correct; with the timed path broken
underneath (`program.planted`), `correct` comes out false; the cell's
control (the program's log-probabilities in bfloat16) reads well above a
sound run and comes out not correct."""

import pytest

import harness
import run

CELLS = {c["name"]: c for c in harness.benchmark_spec()["workloads"]}
WF = "ecoli_mg1655_noclip.pe150.wf"
# the workflow cell is out of BENCHMARK.json until its runs are steady
# enough for a bound (PERF.md, Open questions); its entry stays tested
CELLS.setdefault(WF, {"name": WF, "config": "ecoli_mg1655_noclip",
                      "traffic": "pe150_wf", "chips": 1})
LIB = "ecoli_mg1655_noclip.pe150.lib"
GLIB = "grch38_cut128_noclip.pe150.lib"
GENOME = {
    # an eighth of the genome with an eighth of each family's copies
    "ecoli_mg1655_noclip": {"config.genome.contigs": [
        {"name": "NC_000913.3", "length": 580_000}],
        "config.genome.families": [
            {"name": "rRNA", "length": 5000, "copies": 1,
             "divergence": [0.005, 0.005]},
            {"name": "IS", "length": 1300, "copies": 5,
             "divergence": [0.002, 0.002]},
            {"name": "REP", "length": 35, "copies": 44,
             "divergence": [0.05, 0.05]}]},
    "grch38_cut128_noclip": {"config.genome.contigs": [
        {"name": f"chr{i}", "length": 200_000} for i in (1, 2, 3)]
        + [{"name": "chrM", "length": 16_569}],
        "config.index.group_limit": 450_000},
}
TRAFFIC = {
    "wf": {"traffic.pairs": 4096, "traffic.library.far_min": 100_000,
           "config.options.batch_size": 1024, "traffic.warmup_pairs": 4096,
           "traffic.check.pairs_per_unit": 1024},
    "lib": {"traffic.pairs": 4096, "traffic.library.far_min": 100_000,
            "traffic.batch_pairs": 1024,
            "traffic.tls": {"batch": 1024, "batches": 2},
            "traffic.check.pairs_per_unit": 512},
}
SEED = 2**31 + 77


def scale(cell: str) -> dict:
    return {**GENOME[CELLS[cell]["config"]], **TRAFFIC[cell.rsplit(".", 1)[1]]}


def readings(cell: str, fault=None, seed=SEED):
    out = run.run_cell(CELLS[cell], seed, 0.5, False, device="cpu",
                       fault=fault, scale=scale(cell))
    correct, checks = run.judge(out["checks"], run.limits_for(cell))
    return correct, {k: v[0] for k, v in checks.items()}, out


@pytest.mark.parametrize("cell", [WF, LIB, GLIB])
def test_sound_run_is_correct(cell):
    correct, got, out = readings(cell)
    assert correct, got
    assert out["window"]["units"] >= 1
    assert out["record"]["setup_s"] > 0


@pytest.mark.parametrize("cell,fault,number", [
    (WF, "altered", "nm_wrong"),
    (WF, "half_left_out", "misplaced_pct"),
    (WF, "stale", "misplaced_pct"),
    (WF, "dedup_off", "dup_wrong"),
    (WF, "gapped_polish_off", "misplaced_pct"),
    (LIB, "altered", "nm_wrong"),
    (LIB, "half_left_out", "misplaced_pct"),
    (LIB, "stale", "misplaced_pct"),
    (LIB, "gapped_polish_off", "misplaced_pct"),
    (GLIB, "merge_left_out", "misplaced_pct"),
    (GLIB, "altered", "nm_wrong"),
    (GLIB, "half_left_out", "misplaced_pct"),
    (GLIB, "stale", "misplaced_pct"),
])
def test_fault_makes_the_run_incorrect(cell, fault, number):
    correct, got, _ = readings(cell, fault)
    limits = run.limits_for(cell)
    assert not correct, got
    assert got[number] > limits.get(number, 0), got


@pytest.mark.parametrize("cell", [WF, LIB, GLIB])
def test_control_reads_above_sound_runs(cell):
    """The control (log-probabilities in bfloat16) comes out not correct,
    by the number that tells the two precisions apart."""
    _, sound, _ = readings(cell)
    correct, control, _ = readings(cell, run.limits_for(cell)["_control"])
    limit = run.limits_for(cell)["log_prob_gap"]
    assert not correct, control
    assert control["log_prob_gap"] > limit > sound["log_prob_gap"]
    assert control["log_prob_gap"] >= 3 * sound["log_prob_gap"]
