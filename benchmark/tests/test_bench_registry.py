"""Configurations, traffic mixes, read libraries, cells and metrics are
found by name, and a new one is taken up by adding files alone; BENCHMARK.json keeps to the
benchmark's contract."""

import json
import re
import shutil

import pytest

import harness
import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_find_by_name():
    spec = harness.benchmark_spec()
    for w in spec["workloads"]:
        cfg = harness.find_config(w["config"])
        traffic = harness.find_traffic(w["traffic"])
        assert cfg["name"] == w["config"] and traffic["name"] == w["traffic"]
        assert run.limits_for(w["name"])
        assert traffic["entry"] in run.ENTRIES
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


def test_added_files_are_taken_up(tmp_path):
    """A configuration, a traffic mix and a metric added as files, with a
    cell that names them, are found and read with no code changed."""
    base = tmp_path / "benchmark"
    shutil.copytree(harness.HERE, base, ignore=shutil.ignore_patterns(
        "_cache", "__pycache__", "tests"))
    cfg = harness.find_config("ecoli_mg1655_noclip", base)
    cfg["name"] = "ecoli_other"
    (base / "configs" / "ecoli_other.json").write_text(json.dumps(cfg))
    lib = harness.find_library("novaseq_pe150", base)
    lib["name"] = "novaseq_pe100"
    lib["recipe"]["read_len"] = 100
    (base / "libraries" / "novaseq_pe100.json").write_text(json.dumps(lib))
    tr = harness.load_json(base / "traffic" / "pe150_lib.json")
    tr.update(name="pe100_lib", library="novaseq_pe100")
    (base / "traffic" / "pe100_lib.json").write_text(json.dumps(tr))
    (base / "metrics" / "reads_per_mb.lib.py").write_text(
        "def read(record):\n"
        "    return record['reads'] / record['window_s'] / 1e6\n")
    assert harness.find_config("ecoli_other", base)["name"] == "ecoli_other"
    assert harness.find_traffic("pe100_lib", base)["library"]["read_len"] == 100
    reader = harness.metric_reader("reads_per_mb.lib", base)
    assert reader({"reads": 2e6, "window_s": 2.0}) == 1.0
    spec = harness.benchmark_spec()
    spec["workloads"].append({"name": "ecoli_other.pe100.lib",
                              "config": "ecoli_other", "traffic": "pe100_lib",
                              "chips": 1, "why": "added"})
    spec["per_layer"].append({"name": "reads_per_mb.lib", "unit": "Mreads/s",
                              "better": "higher", "source": "host_clock",
                              "layer": "device", "moves": "align_reads_per_s",
                              "workloads": ["ecoli_other.pe100.lib"]})
    cell = harness.find_cell(spec, "ecoli_other.pe100.lib")
    assert cell["traffic"] == "pe100_lib"
    names = [m["name"] for m in harness.cell_metrics(
        spec, "ecoli_other.pe100.lib", "per_layer")]
    assert names == ["reads_per_mb.lib"]


def test_cell_metrics_follow_workloads():
    spec = harness.benchmark_spec()
    for w in spec["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(spec, w["name"],
                                                       "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        per = harness.cell_metrics(spec, w["name"], "per_layer")
        assert per and all(m["moves"] in e2e for m in per)


def test_benchmark_json_contract():
    spec = harness.benchmark_spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"]
    assert 1 <= spec["run_seconds"] <= 51
    assert 2 + 14 * 24 <= 43200
    names = []
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert json.loads((harness.ROOT / c["file"]).read_text())
        names.append(c["name"])
    used = {w["config"] for w in spec["workloads"]}
    assert used == set(names)
    pairs = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        pairs.add((w["config"], w["traffic"]))
        names += [w["name"], w["traffic"]]
    assert len(pairs) == len(spec["workloads"])
    cells = {w["name"] for w in spec["workloads"]}
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        names.append(m["name"])
    for n in names:
        assert NAME.match(n), n
    for group in (spec["configs"], spec["workloads"],
                  spec["end_to_end"] + spec["per_layer"]):
        assert len({x["name"] for x in group}) == len(group)
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024


@pytest.mark.parametrize("argv", [["--workload", "nope", "--seed", "1",
                                   "--seconds", "1"]])
def test_unknown_cell_raises(argv):
    with pytest.raises(KeyError):
        run.main(argv)
