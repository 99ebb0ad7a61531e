"""The grouped paired run of chip_smoke phase 11 on the CPU, through the
port and through the JAX package: which pairs differ and why, and which
far pairs come out proper.

    python scripts/torch_jax_paired_diff.py [--seed 0] [--pair-seed 6]
        [--pairs 131072] [--batch-size 32768] [--out DIR] [--reference IDX]

Builds phase 9's reference (the 4.6 Mbp genome of --seed as eight contigs
in two groups) with the port's sort-reference on the CPU, or takes
--reference; draws --pairs pairs with synthetic.make_pairs from
--pair-seed (phase 11 draws 262,144 from seed + 6); and runs the paired
workflow on the CPU in two child processes, one for each package (the JAX
one pinned to its CPU backend).  Each child records every batch's joint
log probability of each group, the quantity the cross-group merge takes
the argmax of.  Prints one JSON line: BAM bytes equal, the pairs whose
records differ, how many of those tie exactly across the groups in the
port but not in the JAX package, and the far pairs flagged proper with
the N bases of their mate.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: one package's workflow run, recording the merge's per-group joint log
#: probabilities (argv: package, reference, fastq1, fastq2, out, batch)
CHILD = r"""
import importlib, os, sys
import numpy as np
pkg, ref, fq1, fq2, out, batch = sys.argv[1:7]
kw = {}
if pkg == "isaac_aligner_tpu":
    import jax
    jax.config.update("jax_platforms", "cpu")
else:
    kw["device"] = "cpu"
mi = importlib.import_module(pkg + ".parallel.multi_index")
wf = importlib.import_module(pkg + ".workflow.align")
lps = []
merge = mi.MultiIndexPairedAligner._merge

def recording(self, b1, b2, results):
    def joint(r):
        a1, a2 = np.asarray(r["aligned_1"]), np.asarray(r["aligned_2"])
        lp1 = np.where(a1, np.asarray(r["log_prob_1"]), 0.0)
        lp2 = np.where(a2, np.asarray(r["log_prob_2"]), 0.0)
        return np.where(a1 | a2, lp1 + lp2, -np.inf)
    lps.append(np.stack([joint(r) for r in results]))
    return merge(self, b1, b2, results)

mi.MultiIndexPairedAligner._merge = recording
wf.AlignWorkflow(wf.WorkflowOptions(
    reference=ref, output_dir=out, fastq1=fq1, fastq2=fq2,
    batch_size=int(batch), **kw)).run()
np.save(os.path.join(out, "joint_lp.npy"), np.concatenate(lps, axis=1))
"""
PACKAGES = {"port": "isaac_aligner_tpu_torch", "jax": "isaac_aligner_tpu"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pair-seed", type=int, default=6)
    ap.add_argument("--pairs", type=int, default=131_072)
    ap.add_argument("--batch-size", type=int, default=32_768)
    ap.add_argument("--out", default=None)
    ap.add_argument("--reference", default=None)
    args = ap.parse_args()

    from chip_smoke import GROUP_LIMIT, N_CONTIGS, write_fasta, write_fastq
    from isaac_aligner_tpu_torch import synthetic
    from isaac_aligner_tpu_torch.io.bam import read_bam

    out = Path(args.out or tempfile.mkdtemp(prefix="torch_jax_pe_"))
    out.mkdir(parents=True, exist_ok=True)
    genome = synthetic.make_genome(np.random.default_rng(args.seed),
                                   n_contigs=N_CONTIGS)
    ref = Path(args.reference) if args.reference else out / "idx8"
    if not args.reference:
        write_fasta(out / "ref8.fa", genome)
        subprocess.run([sys.executable, "-m", "isaac_aligner_tpu_torch",
                        "sort-reference", "-g", str(out / "ref8.fa"), "-o",
                        str(ref), "--group-limit", str(GROUP_LIMIT),
                        "--device", "cpu"], cwd=ROOT, check=True)
    sp = synthetic.make_pairs(np.random.default_rng(args.pair_seed),
                              genome.codes, args.pairs)
    for e, reads in ((1, sp.bases1), (2, sp.bases2)):
        write_fastq(out / f"pe{e}.fq", reads, "t")

    env = {**os.environ, "JAX_PLATFORMS": "cpu", "ISAAC_TPU_OUTPUT_PROC": "0"}
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", CHILD, pkg, str(ref), str(out / "pe1.fq"),
         str(out / "pe2.fq"), str(out / name), str(args.batch_size)],
        cwd=ROOT, env=env) for name, pkg in PACKAGES.items()}
    if any(p.wait() for p in procs.values()):
        print(json.dumps({"failed": {n: p.returncode
                                     for n, p in procs.items()}}))
        return 1

    recs, lp = {}, {}
    for name in PACKAGES:
        recs[name] = {(r.qname, r.flag & 0xC0): r
                      for r in read_bam(out / name / "sorted.bam")[2]}
        lp[name] = np.load(out / name / "joint_lp.npy")
    differ = sorted({int(q[1:]) for (q, end), r in recs["port"].items()
                     if recs["jax"].get((q, end)) != r})
    rows = np.array(differ, np.int64)

    def cross_tie(a):
        return np.isfinite(a[0, rows]) & (a[0, rows] == a[1, rows])
    port_tie = cross_tie(lp["port"])
    far_proper = {}
    for name in PACKAGES:
        proper = np.zeros(args.pairs, bool)
        for (q, _end), r in recs[name].items():
            proper[int(q[1:])] |= bool(r.flag & 0x2)
        far_proper[name] = [
            {"pair": int(i), "mate_n_bases": int((sp.bases2[i] == 4).sum())}
            for i in np.nonzero(proper & sp.far)[0]]
    print(json.dumps({
        "pairs": args.pairs, "far_pairs": int(sp.far.sum()),
        "bam_equal": (out / "port" / "sorted.bam").read_bytes()
        == (out / "jax" / "sorted.bam").read_bytes(),
        "pairs_differing": len(differ), "first_differing": differ[:20],
        "cross_group_tie_in_port_not_in_jax": int(
            (port_tie & ~cross_tie(lp["jax"])).sum()),
        "other_differing": int((~port_tie).sum()),
        "far_proper": far_proper}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
