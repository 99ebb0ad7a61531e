"""Multi-process dry run of the PyTorch port: a single-process
`uniform_bins` workflow, then two processes with `dist_processes=2` (gloo
control, each process on its own rows and its own device), FASTQ pairs
to sorted BAM; the two runs' sorted.bam, .bai and .md5 must be
byte-equal and their merged stats counts equal.

    python scripts/torch_multihost_dryrun.py [--device cpu|cuda] [--pairs N]
        [--devices N] [--out DIR] [--reference REF --fastq1 R1 --fastq2 R2]
        [--batch-size B] [--records-per-bin R]

Without --reference it writes scripts/multihost_dryrun.py's fixture (a
9 kbp genome on two contigs, mutated read 1s, duplicate pairs) with
--pairs pairs (80: five batches of 16, a ragged two-process stripe).
With --devices N (> 1; on cpu, N entries of the CPU) the single process
runs the SPMD drivers over an N-device mesh and each of the two over its
own N-device local mesh.  Both processes may share one card.  The
coordinator's port is taken from a free socket.  Prints one JSON line per
process (its stage split, its banded_sw and sw_walk launches and the
pairs they aligned) and a last JSON line with the result; exits non-zero if a
process fails or the outputs differ.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

N_PROCS = 2
OUTPUTS = ("sorted.bam", "sorted.bam.bai", "sorted.bam.md5")
#: MatchSelectorStats.json counts that must not depend on the process count
COUNTS = ("total_reads", "aligned", "perfect", "proper_pairs", "mapq_hist")


def make_fixture(tmp: Path, pairs: int) -> None:
    """scripts/multihost_dryrun.py's fixture with `pairs` pairs."""
    import numpy as np
    rng = np.random.default_rng(11)
    g = "".join("ACGT"[i] for i in rng.integers(0, 4, 9000))
    (tmp / "ref.fa").write_text(">c1\n" + g[:5000] + "\n>c2\n"
                                + g[5000:] + "\n")

    def rc(s):
        return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]

    with open(tmp / "r1.fq", "w") as f1, open(tmp / "r2.fq", "w") as f2:
        for i in range(pairs):
            p = int(rng.integers(0, 9000 - 500))
            t = int(rng.integers(300, 460))
            s1 = list(g[p:p + 80])
            if i % 5 == 1:
                for j in range(0, 80, 9):
                    s1[j] = "ACGT"[("ACGT".index(s1[j]) + 1) % 4]
            if i % 7 == 2:   # duplicates: groups that span the processes
                p, t = 800, 350
                s1 = list(g[p:p + 80])
            s2 = rc(g[p + t - 80:p + t])
            q = "".join(chr(33 + int(x)) for x in rng.integers(20, 40, 80))
            f1.write(f"@rd{i}\n{''.join(s1)}\n+\n{q}\n")
            f2.write(f"@rd{i}\n{s2}\n+\n{'I' * 80}\n")


def workflow_opts(args, out: Path, **kw):
    from isaac_aligner_tpu_torch.workflow.align import WorkflowOptions
    return WorkflowOptions(
        reference=args.reference, fastq1=args.fastq1, fastq2=args.fastq2,
        output_dir=str(out), batch_size=args.batch_size,
        records_per_bin=args.records_per_bin, tls_batches=2,
        device=args.device, devices=args.devices, **kw)


def child_main(args) -> None:
    from isaac_aligner_tpu_torch.ops import sw
    from isaac_aligner_tpu_torch.workflow.align import AlignWorkflow
    pid = int(os.environ["ISAAC_TPU_DIST_PROCID"])
    run = AlignWorkflow(workflow_opts(
        args, Path(args.out) / "outN", dist_coordinator=args.coordinator,
        dist_processes=N_PROCS, dist_process_id=pid))
    run.run()
    ms = run._stats["match_selector"]
    print(json.dumps({"process": pid, "align_seconds": ms["align_seconds"],
                      "stage_seconds": ms["stage_seconds"],
                      "launches": sw.banded_sw.launches,
                      "walk_launches": sw.sw_walk.launches,
                      "sw_pairs": ms["device_work"]["sw_pairs"]}), flush=True)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def counts(out: Path) -> dict:
    ms = json.loads((out / "Stats" / "MatchSelectorStats.json").read_text())
    state = json.loads((out / "Temp" / "AlignerState.json").read_text())
    finder = state["stats"].get("match_finder", {})
    return {"match_selector": {k: ms[k] for k in COUNTS},
            "match_finder": {k: v for k, v in finder.items()
                             if isinstance(v, int)}}


def main(args) -> int:
    out = Path(args.out)
    t0 = time.perf_counter()
    from isaac_aligner_tpu_torch.workflow.align import AlignWorkflow
    AlignWorkflow(workflow_opts(args, out / "out1", uniform_bins=True)).run()
    single_s = time.perf_counter() - t0

    cmd = [sys.executable, str(Path(__file__).resolve()), "--child",
           "--coordinator", f"127.0.0.1:{free_port()}"]
    for k in ("device", "devices", "out", "reference", "fastq1", "fastq2",
              "batch_size", "records_per_bin"):
        cmd += [f"--{k.replace('_', '-')}", str(getattr(args, k))]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, env={**os.environ,
                                        "ISAAC_TPU_DIST_PROCID": str(pid)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for pid in range(N_PROCS)]
    logs, ok = [], True
    try:
        for pid, pr in enumerate(procs):
            text, _ = pr.communicate(timeout=args.timeout)
            logs.append(text)
            if pr.returncode:
                ok = False
                print(f"--- process {pid} rc={pr.returncode} ---\n"
                      + text[-4000:], flush=True)
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    multi_s = time.perf_counter() - t0
    if not ok:
        return 1
    for text in logs:
        for line in text.splitlines():
            if line.startswith('{"process"'):
                print(line, flush=True)

    diff = [name for name in OUTPUTS
            if (out / "out1" / name).read_bytes()
            != (out / "outN" / name).read_bytes()]
    c1, cn = counts(out / "out1"), counts(out / "outN")
    result = {"byte_identical": not diff, "differ": diff,
              "counts_equal": c1 == cn, "counts": cn,
              "bam_bytes": (out / "outN" / "sorted.bam").stat().st_size,
              "single_s": round(single_s, 3), "multi_s": round(multi_s, 3),
              "processes": N_PROCS, "device": args.device,
              "devices": args.devices}
    print(json.dumps(result), flush=True)
    if diff or c1 != cn:
        print(f"single-process counts {c1}", flush=True)
        return 1
    print(f"multi-process dry run OK: {N_PROCS} processes on "
          f"{args.device}, BAM byte-identical", flush=True)
    return 0


def parse_args():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pairs", type=int, default=80)
    ap.add_argument("--devices", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--reference")
    ap.add_argument("--fastq1")
    ap.add_argument("--fastq2")
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--records-per-bin", type=int, default=48)
    ap.add_argument("--timeout", type=int, default=1800)
    ap.add_argument("--child", action="store_true")
    ap.add_argument("--coordinator")
    return ap.parse_args()


if __name__ == "__main__":
    a = parse_args()
    if a.child:
        child_main(a)
        sys.exit(0)
    if a.out is None:
        a.out = tempfile.mkdtemp(prefix="isaac_torch_mh_")
    Path(a.out).mkdir(parents=True, exist_ok=True)
    if a.reference is None:
        make_fixture(Path(a.out), a.pairs)
        a.reference = str(Path(a.out) / "ref.fa")
        a.fastq1 = str(Path(a.out) / "r1.fq")
        a.fastq2 = str(Path(a.out) / "r2.fq")
    sys.exit(main(a))
