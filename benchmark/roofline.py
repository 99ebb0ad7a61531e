"""Published peaks of the cards and the operation and byte counts of the
program's kernels, from their launch shapes.

Peaks are NVIDIA's data-sheet figures for the H100 SXM5 part, dense, at
its full 700 W power limit; a run prints the card's own limit beside them
(`harness.power_limit`).  The data sheet's 67 TFLOP/s of float32 counts a
fused multiply-add as two operations; the adds, maxima and compares of
the banded Smith-Waterman recurrence issue one a lane a clock, half that
rate, so the kernel's operations are held against `f32_lane_ops`.
"""

from __future__ import annotations

import math

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "f32_flops": 67e12,
        "f32_lane_ops": 33.5e12,
        "hbm_bytes_per_s": 3.35e12,
        "source": "NVIDIA H100 Tensor Core GPU data sheet, SXM5 (700 W)",
    },
}

#: diagonal band of the banded SW kernel and the query rows packed in one
#: traceback word (isaac_aligner_tpu_torch/ops/sw.py BAND, TB_PACK)
SW_BAND = 16
SW_TB_PACK = 5


def banded_sw_counts(n: int, l: int, band: int = SW_BAND) -> tuple[int, int]:
    """(float32 operations, bytes) one launch of `n` pairs of length `l`
    needs.  A band cell (query row i, diagonal d) takes the G move (a max
    of three states, one add of the substitution score: 3 ops) and the F
    move (three adds of open or extend, a max of three: 5 ops); the E move
    along the band (three adds, a max of three: 5 ops) exists for
    d >= 1.  Bytes: the uint8 query [n, l] and window [n, l + band - 1]
    read once, the float32 final row [n, band] and the int32 packed
    traceback [n, ceil(l / 5), band] written once."""
    ops = n * l * (8 * band + 5 * (band - 1))
    nbytes = n * l + n * (l + band - 1) + 4 * n * band \
        + 4 * n * math.ceil(l / SW_TB_PACK) * band
    return ops, nbytes


def least_seconds(shapes, peaks: dict) -> tuple[float, str]:
    """Least time the launches `shapes` ([(n, l)]) could take on a card
    of `peaks`, and which of operations or bytes bounds more of it."""
    t_ops = t_bytes = total = 0.0
    for n, l in shapes:
        ops, nbytes = banded_sw_counts(n, l)
        a = ops / peaks["f32_lane_ops"]
        b = nbytes / peaks["hbm_bytes_per_s"]
        total += max(a, b)
        t_ops += a
        t_bytes += b
    return total, ("operations" if t_ops >= t_bytes else "bytes")


def roofline_pct(shapes, kernel_seconds: float, peaks: dict | None):
    """Share (%) of the least time in the measured kernel time, or None
    without launches, time or the card's peaks."""
    if not shapes or not kernel_seconds or peaks is None:
        return None, None
    least, bound = least_seconds(shapes, peaks)
    return 100.0 * least / kernel_seconds, bound
