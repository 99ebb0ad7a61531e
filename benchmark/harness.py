"""The benchmark's data-driven core: it finds configurations, traffic
mixes, cells and per-layer metric readers by name, and holds the rules a
run keeps whatever the cell (the JAX check, the card record, the cache
directories, the result line).

A configuration is `configs/<name>.json`, a traffic mix
`traffic/<name>.json` (which names a read library's recipe,
`libraries/<name>.json`), a per-layer metric `metrics/<name>.py` (a
module with `read(record) -> float | None`), all found by the names that
`BENCHMARK.json` gives.  Adding a cell, a mix, a configuration or a
metric adds files and entries only.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: top-level module names that may not be loaded in a run's process: the
#: JAX stack and the JAX package (compared whole, so the port, whose name
#: begins with the JAX package's, passes)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "isaac_aligner_tpu")


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def benchmark_spec(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return load_json(path)


def find_config(name: str, base: Path = HERE) -> dict:
    return load_json(base / "configs" / f"{name}.json")


def find_library(name: str, base: Path = HERE) -> dict:
    return load_json(base / "libraries" / f"{name}.json")


def find_traffic(name: str, base: Path = HERE) -> dict:
    """A traffic mix, with the recipe of the library it names in place of
    the name."""
    traffic = load_json(base / "traffic" / f"{name}.json")
    traffic["library"] = find_library(traffic["library"], base)["recipe"]
    return traffic


def find_cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metric_reader(name: str, base: Path = HERE):
    """The `read` function of `metrics/<name>.py`."""
    path = base / "metrics" / f"{name}.py"
    mod_name = "bench_metric_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(spec: dict, cell: str, kind: str) -> list[dict]:
    """The `end_to_end` or `per_layer` metrics that `cell` reports: those
    whose `workloads` list names it, or that have no such list and move
    (per-layer) or are (end-to-end) a metric the cell reports."""
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def forbidden_loaded(modules=None) -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN_MODULES."""
    modules = sys.modules if modules is None else modules
    tops = {name.split(".", 1)[0] for name in list(modules)
            if modules.get(name) is not None}
    return sorted(tops & set(FORBIDDEN_MODULES))


def cache_dirs(root: Path = ROOT) -> dict[str, Path]:
    """Fixed directories inside the checkout for what a run builds once:
    Triton's cache and the benchmark's reference indexes.  The program's
    kernels build into its own fixed `_build/` directories."""
    base = root / "benchmark" / "_cache"
    return {"triton": base / "triton", "index": base / "index"}


def set_cache_env(root: Path = ROOT) -> None:
    d = cache_dirs(root)
    for p in d.values():
        p.mkdir(parents=True, exist_ok=True)
    os.environ["TRITON_CACHE_DIR"] = str(d["triton"])


def card_record(torch, chips: int) -> dict:
    """The device record of the result line; raises when the run has no
    card or fewer than the cell asks for."""
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no card")
    count = torch.cuda.device_count()
    if count < chips:
        raise RuntimeError(f"the cell asks for {chips} cards, "
                           f"{count} visible")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}


def power_limit() -> str:
    """The card's name and power limit from nvidia-smi ("" without it)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=False)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def s_per_mread(seconds: float | None, reads: int) -> float | None:
    """Seconds a million reads (None without reads or a time)."""
    if seconds is None or not reads:
        return None
    return seconds * 1e6 / reads


def metric_value(value) -> float | None:
    if value is None:
        return None
    v = float(value)
    return v if math.isfinite(v) else None


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: dict, breakdown: dict | None = None
                ) -> str:
    """The last line of standard output; `checks` ({name: [number,
    limit]}) comes last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)
