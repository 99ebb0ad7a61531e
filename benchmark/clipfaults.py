"""Readings of the numbers that decide `correct` with a fault of a default
pass planted: `control.py`'s runs and output lines, with these faults
besides those of `program.planted`:

- `trim_out_of_sw`: quality-trimmed ends kept out of the gapped polish
  (its `masked` left out), as the port had it before the mend;
- `overlap_whole_read`: the overlap clip worked out from each end's whole
  read length at its current start, an earlier soft clip dropped and NM
  left as it was, as the port had it before the mend;
- `indel_passes_off`: neither the gapped polish nor the simple-indel
  aligner runs, so an end with an indel stays ungapped;
- `trim_start_kept`: a reverse end's masked tail soft-clipped at the lead
  without its start moving past the clip.

    python benchmark/clipfaults.py --workload grch38_cut128.pe150.lib \\
        --seeds 1,2,3 --seconds 8 --faults trim_out_of_sw,indel_passes_off

A measuring tool for setting the cell's limits; `run.py` never plants
anything.
"""

from __future__ import annotations

import contextlib
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))
if str(HERE.parent) not in sys.path:
    sys.path.insert(1, str(HERE.parent))

import control  # noqa: E402
import program  # noqa: E402

FAULTS = ("trim_out_of_sw", "overlap_whole_read", "indel_passes_off",
          "trim_start_kept")


def overlap_whole_read(res: dict, b1, b2, genome_codes) -> int:
    """The overlap clip from whole read lengths: FR pairs whose reads,
    laid from their current starts, overlap; the end whose 3' tail over
    the overlap sums the lower quality (the right one on a tie) gets the
    CIGAR of a clip of the whole read, its other clips dropped."""
    a = res["aligned_1"].astype(bool) & res["aligned_2"].astype(bool)
    r1, r2 = res["reverse_1"].astype(bool), res["reverse_2"].astype(bool)
    p1 = res["start_1"].astype(np.int64)
    p2 = res["start_2"].astype(np.int64)
    l1, l2 = b1.read_len, b2.read_len
    left1 = p1 <= p2
    rp = np.where(left1, p2, p1)
    ll, rl = np.where(left1, l1, l2), np.where(left1, l2, l1)
    ov = np.where(left1, p1, p2) + ll - rp
    cand = a & (r1 != r2) & ~np.where(left1, r1, r2) & (ov > 0) & \
        (ov < ll) & (ov < rl)
    n = a.shape[0]
    for key in ("cigar_1", "cigar_2"):
        res.setdefault(key, [None] * n)
    rows = [i for i in np.nonzero(cand)[0].tolist()
            if not any(c and ("I" in c or "D" in c)
                       for c in (res["cigar_1"][i], res["cigar_2"][i]))]
    for i in rows:
        o = int(ov[i])
        q1 = int(b1.quals[i, ::-1][:o].astype(np.int64).sum())
        q2 = int(b2.quals[i, ::-1][:o].astype(np.int64).sum())
        left_q, right_q = (q1, q2) if left1[i] else (q2, q1)
        clip_right = left_q >= right_q
        e = ("_2" if left1[i] else "_1") if clip_right else \
            ("_1" if left1[i] else "_2")
        length = l1 if e == "_1" else l2
        if clip_right:
            res["cigar" + e][i] = f"{o}S{length - o}M"
            res["start" + e][i] = int(rp[i]) + o
        else:
            res["cigar" + e][i] = f"{length - o}M{o}S"
    return len(rows)


@contextlib.contextmanager
def planted(name: str | None, _base=program.planted):
    """`program.planted`, knowing FAULTS too."""
    if name not in FAULTS:
        with _base(name):
            yield
        return
    from isaac_aligner_tpu_torch import aligner
    from isaac_aligner_tpu_torch.align import clippers
    patched = []

    def patch(owner, attr, new):
        patched.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, new)

    if name == "trim_out_of_sw":
        gapped = aligner.polish_gapped
        patch(aligner, "polish_gapped",
              lambda *a, masked=None, **k: gapped(*a, **k))
    elif name == "overlap_whole_read":
        patch(clippers, "clip_overlapping", overlap_whole_read)
    elif name == "indel_passes_off":
        patch(aligner, "polish_gapped", lambda *a, **k: 0)
        patch(aligner, "polish_simple_indels",
              lambda *a, **k: np.zeros(0, np.int64))
    else:
        masked_tail = clippers.apply_masked_tail_cigar

        def start_kept(res, suffix, trims, read_len):
            written = masked_tail(res, suffix, trims, read_len)
            back = res["reverse" + suffix].astype(bool) & (written > 0)
            res["start" + suffix][back] -= written[back].astype(
                res["start" + suffix].dtype)
            return written
        patch(clippers, "apply_masked_tail_cigar", start_kept)
    try:
        yield
    finally:
        for owner, attr, orig in reversed(patched):
            setattr(owner, attr, orig)


def main(argv=None) -> int:
    program.planted = planted
    return control.main(argv)


if __name__ == "__main__":
    sys.exit(main())
