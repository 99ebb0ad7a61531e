"""Child-process-safe stats aggregation helpers (numpy only, so the
output subprocess can run them; workflow/output_proc.py).

The port's own copy of `isaac_aligner_tpu/workflow/stats_agg.py`,
unchanged.

Reference analogs: per-tile histograms (MatchSelectorStatsXml.cpp /
TileBarcodeStats.hh) and the ZX/ZY cluster-coordinate tags
(FragmentAccessorBamAdapter.hh)."""

from __future__ import annotations

import numpy as np

from ..io import sam


def coords_from_names(names: list[str]):
    """Cluster X/Y from Illumina read names
    '<inst>:<run>:<fc>:<lane>:<tile>:<x>:<y>' -> int32 arrays (ZX/ZY
    tags).  Returns (None, None) when names don't carry coordinates."""
    arr = np.asarray(names, dtype="U")
    p1 = np.char.rpartition(arr, ":")
    y, rest = p1[:, 2], p1[:, 0]
    p2 = np.char.rpartition(rest, ":")
    x = p2[:, 2]
    try:
        return (x.astype(np.int64).astype(np.int32),
                y.astype(np.int64).astype(np.int32))
    except ValueError:
        return None, None


def tile_agg(names, fb, mapped, per_tile: dict,
             rg_names: tuple[str, ...], synth_tile=None) -> None:
    """Per-(lane, tile, barcode/sample, read#) yield aggregation from
    Illumina read names (vectorized prefix grouping).  `names` is one
    entry per RECORD.  `synth_tile=(lane, tile)` bypasses name parsing
    for inputs without Illumina names (FASTQ/BAM): the whole batch lands
    in one synthesized tile, mirroring FastqDataSource.hh:41-118."""
    if synth_tile is not None:
        lane, tile = synth_tile
        uniq = np.asarray([f"synth:0:0:{lane}:{tile}"], dtype="U")
        inv = np.zeros(len(fb), np.int64)
    else:
        names = np.asarray(names, dtype="U")
        pre = np.char.rpartition(
            np.char.rpartition(names, ":")[:, 0], ":")[:, 0]
        uniq, inv = np.unique(pre, return_inverse=True)
    n_rg = max(len(rg_names), 1)
    rg = (np.clip(fb.rg, 0, n_rg - 1) if rg_names
          else np.zeros(len(fb), np.int64)).astype(np.int64)
    read2 = ((fb.flag & sam.FLAG_READ2) != 0).astype(np.int64)
    key = (inv.astype(np.int64) * n_rg + rg) * 2 + read2
    nk = len(uniq) * n_rg * 2
    L = fb.qual.shape[1]
    in_read = np.arange(L)[None, :] < fb.length[:, None]
    q30 = ((fb.qual >= 30) & in_read).sum(axis=1)
    perfect = (mapped & (fb.nm == 0)).astype(np.float64)

    w = lambda v: np.bincount(key, weights=np.asarray(v, np.float64),
                              minlength=nk)
    tot = np.bincount(key, minlength=nk)
    agg_cols = {"aligned": w(mapped), "perfect": w(perfect),
                "yield": w(fb.length), "yield_q30": w(q30),
                "mapq_sum": w(fb.mapq.astype(np.float64) * mapped)}
    for flat in np.nonzero(tot)[0]:
        ti, rest = divmod(int(flat), n_rg * 2)
        ri, e = divmod(rest, 2)
        parts = str(uniq[ti]).split(":")
        if len(parts) < 5:
            continue
        sample = rg_names[ri] if rg_names else "all"
        agg = per_tile.setdefault(
            (parts[3], parts[4], sample, e + 1),
            {"total": 0, "aligned": 0, "perfect": 0, "yield": 0,
             "yield_q30": 0, "mapq_sum": 0})
        agg["total"] += int(tot[flat])
        for cname, col in agg_cols.items():
            agg[cname if cname != "aligned" else "aligned"] += \
                int(col[flat])
