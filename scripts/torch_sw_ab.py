#!/usr/bin/env python3
"""Time the port's banded SW kernel against another tree's, on one GPU.

Loads `isaac_aligner_tpu_torch` from this checkout and from each
`--other` tree (an unpacked copy of another commit, e.g. `git archive
<commit> | tar -x -C _chip_tree/parent`), builds every kernel, checks that
they agree bit for bit with each other and with the plain torch version,
then times the wrappers in turns (others, this, this, others reversed) at
each shape.  Each timing
is CUDA events around `--reps` back-to-back calls, queued behind a sleep
kernel so the host's enqueue time does not show; it covers the whole
wrapper's device work (the kernel and any copies around it).

    python3 scripts/torch_sw_ab.py --other _chip_tree/parent \\
        [--other DIR ...] [--shapes 896x100,8192x100] [--reps 100]

Prints one line per shape and, last, one JSON object with every time and
the card's name and power limit.  Needs torch, numpy, nvcc and one GPU.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

# one timing rule and one pair maker for this script and the smoke test
from chip_smoke import card_line, cuda_ms, sw_pairs  # noqa: E402


def load_port(root: Path, name: str):
    """Import root/isaac_aligner_tpu_torch as package `name`; return its
    ops.sw module."""
    pkg = root / "isaac_aligner_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{name}.ops.sw")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, action="append", required=True)
    ap.add_argument("--shapes", default="896x100,8192x100")
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no GPU")
    dev = torch.device("cuda")
    ports = {"this": load_port(REPO, "port_this")}
    for k, root in enumerate(args.other):
        ports[str(root)] = load_port(root.resolve(), f"port_other{k}")
    this = ports["this"]
    order = [str(r) for r in args.other]
    order = order + ["this", "this"] + order[::-1]
    card = card_line()
    rng = np.random.default_rng(args.seed)
    rows = []
    for shape in args.shapes.split(","):
        n, l = (int(x) for x in shape.split("x"))
        q, db = sw_pairs(rng, n, l)
        qd, dbd = torch.from_numpy(q).to(dev), torch.from_numpy(db).to(dev)
        g_p, tb_p = this.banded_sw_torch(qd, dbd)
        for who, sw in ports.items():
            g, tb = sw.banded_sw(qd, dbd)
            torch.cuda.synchronize()
            if not (torch.equal(g, g_p) and torch.equal(tb, tb_p)):
                raise AssertionError(f"{who} != plain at N={n} L={l}")
            for _ in range(5):
                sw.banded_sw(qd, dbd)
        times = {who: [] for who in ports}
        for who in order:
            sw = ports[who]
            times[who].append(cuda_ms(lambda: sw.banded_sw(qd, dbd),
                                      args.reps))
        rows.append({"n": n, "l": l, "ms": times})
        print(f"N={n} L={l}: " + "; ".join(
            f"{who} {t} ms" for who, t in times.items()) + f" [{card}]",
            flush=True)
    print(json.dumps({"card": card, "reps": args.reps, "rows": rows}))


if __name__ == "__main__":
    main()
