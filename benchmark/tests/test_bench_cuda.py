"""On the card, at a small size: a traced run of each cell is correct and
its trace finds device work and the banded SW kernel; the control reads
above a sound run."""

import pytest

import run
from test_bench_faults import CELLS, LIB, SEED, WF, scale


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [WF, LIB])
def test_traced_run_on_the_card(card, cell):
    out = run.run_cell(CELLS[cell], SEED, 2.0, True, device=card,
                       scale=scale(cell))
    correct, checks = run.judge(out["checks"], run.limits_for(cell))
    assert correct, checks
    prof = out["record"]["profile"]
    assert 0 < prof["busy_s"] <= prof["window_s"]
    assert out["record"]["device_peak_bytes"] > 0
    if cell == LIB:
        assert out["record"]["sw_launches"]
        assert any("banded_sw" in k for k in prof["op_seconds"])


@pytest.mark.cuda
def test_control_on_the_card(card):
    sound = run.run_cell(CELLS[LIB], SEED, 1.0, False, device=card,
                         scale=scale(LIB))["checks"]
    out = run.run_cell(CELLS[LIB], SEED, 1.0, False, device=card,
                       fault=run.limits_for(LIB)["_control"], scale=scale(LIB))
    correct, _ = run.judge(out["checks"], run.limits_for(LIB))
    control = out["checks"]
    assert not correct
    assert control["log_prob_gap"] > run.limits_for(LIB)["log_prob_gap"]
    assert control["log_prob_gap"] >= 3 * sound["log_prob_gap"]
