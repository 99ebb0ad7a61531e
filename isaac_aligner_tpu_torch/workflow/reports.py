"""Stats artifacts: XML files + self-contained HTML report.

The port's own copy of `isaac_aligner_tpu/workflow/reports.py`, unchanged.
Reference analogs:
  - MatchSelectorStats.xml   lib/alignment/matchSelector/MatchSelectorStatsXml.cpp
  - DemultiplexingStats.xml  FindMatchesTransition.cpp:606-659
  - BuildStats.xml           lib/build/BuildStatsXml.cpp
  - HTML report              lib/reports/AlignmentReportGenerator.cpp:65-154
    (libxslt + gnuplot there; a direct HTML writer with inline SVG plots
    here — no external tools).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from pathlib import Path


def _write(root: ET.Element, path: Path) -> None:
    ET.indent(root)
    ET.ElementTree(root).write(path, encoding="utf-8", xml_declaration=True)


def write_match_selector_stats_xml(stats: dict, path: str | Path,
                                   sample: str = "sample") -> None:
    """Yield / alignment-quality stats (MatchSelectorStatsXml.cpp layout:
    Stats/Flowcell/Lane/Tile nesting collapses to one logical tile here —
    the device pipeline has no physical tiles)."""
    root = ET.Element("Stats")
    fc = ET.SubElement(root, "Flowcell", {"flowcell-id": "all"})
    proj = ET.SubElement(fc, "Project", name="default")
    smp = ET.SubElement(proj, "Sample", name=sample)
    bc = ET.SubElement(smp, "Barcode", name="all")
    # per-(lane, tile) breakdown with nested barcode x read histograms
    # when the input was a BCL run folder (reference tile x barcode x read
    # stats, MatchSelectorStatsXml.cpp / TileBarcodeStats.hh)
    tiles: dict[tuple, list] = {}
    for t in stats.get("tiles", []):
        tiles.setdefault((str(t["lane"]), str(t["tile"])), []).append(t)
    for (lane, tile_no), rows in sorted(tiles.items()):
        te = ET.SubElement(bc, "Tile", number=tile_no, lane=lane)
        ET.SubElement(te, "Count").text = str(sum(r["total"] for r in rows))
        ET.SubElement(te, "Aligned").text = str(
            sum(r["aligned"] for r in rows))
        by_bc: dict[str, list] = {}
        for r in rows:
            by_bc.setdefault(str(r.get("barcode", "all")), []).append(r)
        for bname, brows in sorted(by_bc.items()):
            be = ET.SubElement(te, "Barcode", name=bname)
            for r in sorted(brows, key=lambda x: x.get("read", 1)):
                re_ = ET.SubElement(be, "Read",
                                    number=str(r.get("read", 1)))
                ET.SubElement(re_, "ClusterCount").text = str(r["total"])
                ET.SubElement(re_, "Aligned").text = str(r["aligned"])
                for tag, key in (("Perfect", "perfect"), ("Yield", "yield"),
                                 ("YieldQ30", "yield_q30"),
                                 ("MapqSum", "mapq_sum")):
                    if key in r:
                        ET.SubElement(re_, tag).text = str(int(r[key]))
    tile = ET.SubElement(bc, "Tile", number="0")
    frag = ET.SubElement(tile, "AllFragments")
    total = int(stats.get("total_reads", 0))
    aligned = int(stats.get("aligned", 0))
    ET.SubElement(frag, "Count").text = str(total)
    ET.SubElement(frag, "Aligned").text = str(aligned)
    ET.SubElement(frag, "Perfect").text = str(stats.get("perfect", 0))
    ET.SubElement(frag, "ProperPairs").text = str(stats.get("proper_pairs", 0))
    pct = 100.0 * aligned / total if total else 0.0
    ET.SubElement(frag, "PercentAligned").text = f"{pct:.2f}"
    hist = stats.get("mapq_hist")
    if hist:
        h = ET.SubElement(frag, "MapqDistribution")
        for q, n in enumerate(hist):
            if n:
                ET.SubElement(h, "Mapq", value=str(q)).text = str(int(n))
    _write(root, Path(path))


def write_demultiplexing_stats_xml(counts: dict[str, int],
                                   path: str | Path) -> None:
    """Per-sample cluster counts (DemultiplexingStats.xml analog)."""
    root = ET.Element("Stats")
    fc = ET.SubElement(root, "Flowcell", {"flowcell-id": "all"})
    lane = ET.SubElement(fc, "Lane", number="0")
    for sample_name, n in sorted(counts.items()):
        b = ET.SubElement(lane, "Barcode", name=sample_name)
        ET.SubElement(b, "ClusterCount").text = str(int(n))
    _write(root, Path(path))


def write_match_finder_stats_xml(finder: dict, path: str | Path) -> None:
    """Seed-matching outcome tallies (statistics lib analog:
    include/statistics/MatchFinderTileStats.hh): one Tile element per
    batch tally (reference MatchTally per (iteration, tile)) plus the
    run totals."""
    keys = ("seeds_no_match", "seeds_too_many", "pass2_reads",
            "pass2_dropped")
    tag_of = lambda k: "".join(w.capitalize() for w in k.split("_"))
    root = ET.Element("Stats")
    for i, t in enumerate(finder.get("tally") or [finder]):
        tile = ET.SubElement(root, "Tile", number=str(i))
        for k in keys:
            if k in t:
                ET.SubElement(tile, tag_of(k)).text = str(int(t[k]))
    total = ET.SubElement(root, "Total")
    for k in keys:
        if k in finder:
            ET.SubElement(total, tag_of(k)).text = str(int(finder[k]))
    if "anomalous_pairs" in finder:
        ET.SubElement(total, "AnomalousPairs").text = \
            str(int(finder["anomalous_pairs"]))
    _write(root, Path(path))


def write_build_stats_xml(build: dict, path: str | Path) -> None:
    """Per-run duplicate/realignment counts (BuildStats.xml analog)."""
    root = ET.Element("Stats")
    b = ET.SubElement(root, "Bin", index="0")
    ET.SubElement(b, "Total").text = str(build.get("records", 0))
    dup = int(build.get("duplicates", 0))
    ET.SubElement(b, "Unique").text = str(int(build.get("records", 0)) - dup)
    ET.SubElement(b, "Duplicates").text = str(dup)
    ET.SubElement(b, "Realigned").text = str(build.get("realigned", 0))
    _write(root, Path(path))


def _mapq_svg(hist: list[int], width: int = 640, height: int = 200) -> str:
    """Inline SVG bar chart of the MAPQ distribution (the gnuplot analog)."""
    if not hist or not any(hist):
        return "<p>no mapped reads</p>"
    n = len(hist)
    peak = max(hist)
    bar_w = width / n
    bars = []
    for q, v in enumerate(hist):
        if not v:
            continue
        h = max(1.0, height * v / peak)
        bars.append(
            f'<rect x="{q * bar_w:.1f}" y="{height - h:.1f}" '
            f'width="{max(bar_w - 1, 1):.1f}" height="{h:.1f}" '
            f'fill="#4878a8"><title>MAPQ {q}: {v}</title></rect>')
    axis = (f'<line x1="0" y1="{height}" x2="{width}" y2="{height}" '
            'stroke="#333"/>')
    labels = "".join(
        f'<text x="{q * bar_w:.1f}" y="{height + 14}" font-size="10">{q}</text>'
        for q in range(0, n, 10))
    return (f'<svg width="{width}" height="{height + 20}" '
            f'xmlns="http://www.w3.org/2000/svg">{"".join(bars)}{axis}'
            f'{labels}</svg>')


def write_html_report(stats: dict, path: str | Path,
                      image_format: str = "svg") -> None:
    """Self-contained HTML report (AlignmentReportGenerator analog).
    image_format: svg | gif | none (reference --stats-image-format,
    manual.md:545; 'none' skips plots, 'gif' is accepted for
    compatibility and renders the same inline SVG)."""
    ms = stats.get("match_selector", {})
    build = stats.get("build", {})
    demux = stats.get("demultiplexing", {})
    tls = stats.get("tls", {})

    def table(d: dict, skip=("mapq_hist",)) -> str:
        rows = "".join(f"<tr><td>{k}</td><td>{v}</td></tr>"
                       for k, v in d.items() if k not in skip)
        return f'<table border="1" cellpadding="4">{rows}</table>'

    total = max(int(ms.get("total_reads", 0)), 1)
    aligned = int(ms.get("aligned", 0))
    parts = [
        "<html><head><title>Alignment report</title>",
        "<style>body{font-family:sans-serif} h2{margin-top:1.5em}</style>",
        "</head><body><h1>Alignment report</h1>",
        f"<p><b>{aligned}</b> of <b>{total}</b> reads aligned "
        f"({100.0 * aligned / total:.2f}%)</p>",
        "<h2>Match selector</h2>", table(ms),
    ]
    if image_format != "none":
        parts += ["<h2>MAPQ distribution</h2>",
                  _mapq_svg(ms.get("mapq_hist", []))]
    if tls:
        parts += ["<h2>Template length statistics</h2>", table(tls)]
    if demux:
        parts += ["<h2>Demultiplexing</h2>", table(demux)]
    tiles = ms.get("tiles")
    if tiles and image_format != "none":
        parts += ["<h2>Per-tile plots</h2>", _tile_grid_svg(tiles)]
    if build:
        parts += ["<h2>Build (sort/dedup/realign)</h2>", table(build)]
    parts.append("</body></html>")
    Path(path).write_text("".join(parts))


def _tile_grid_svg(tiles: list[dict]) -> str:
    """Per-tile mini-plot grid: %-aligned, %-Q30-yield and mean-MAPQ bars
    per (lane, tile), all samples/reads combined.

    Reference analog: AlignmentReportGenerator's per-tile gnuplot image
    set (lib/reports/AlignmentReportGenerator.cpp:65-154) — one panel per
    tile instead of one image file per tile."""
    agg: dict[tuple[str, str], dict] = {}
    for row in tiles:
        key = (str(row.get("lane")), str(row.get("tile")))
        a = agg.setdefault(key, {"total": 0, "aligned": 0, "yield": 0,
                                 "yield_q30": 0, "mapq_sum": 0})
        for k in a:
            a[k] += int(row.get(k, 0))
    if not agg:
        return ""
    pw, ph, gap = 84, 90, 10
    per_row = max(1, 720 // (pw + gap))
    panels = []
    colors = ("#4878a8", "#6aa84f", "#b46ac8")
    for i, (key, a) in enumerate(sorted(agg.items())):
        x0 = (i % per_row) * (pw + gap)
        y0 = (i // per_row) * (ph + 26)
        frac_al = a["aligned"] / max(a["total"], 1)
        frac_q30 = a["yield_q30"] / max(a["yield"], 1)
        mapq = a["mapq_sum"] / max(a["aligned"], 1) / 60.0
        bars = []
        for j, (v, label) in enumerate(
                ((frac_al, "aligned"), (frac_q30, "Q30"), (mapq, "MAPQ"))):
            h = max(1.0, (ph - 14) * min(v, 1.0))
            bx = x0 + 6 + j * 26
            bars.append(
                f'<rect x="{bx}" y="{y0 + ph - h:.1f}" width="20" '
                f'height="{h:.1f}" fill="{colors[j]}">'
                f'<title>lane {key[0]} tile {key[1]} {label}: '
                f'{v * 100:.1f}{"%" if j < 2 else " (x60)"} '
                f'({a["total"]} reads)</title></rect>')
        panels.append(
            f'<g>{"".join(bars)}'
            f'<rect x="{x0}" y="{y0}" width="{pw}" height="{ph}" '
            f'fill="none" stroke="#ccc"/>'
            f'<text x="{x0 + 4}" y="{y0 + ph + 13}" font-size="9">'
            f'L{key[0]} T{key[1]}</text></g>')
    rows = -(-len(agg) // per_row)
    width = per_row * (pw + gap)
    height = rows * (ph + 26)
    legend = ('<text x="0" y="-6" font-size="10">'
              'blue=%aligned green=%Q30 purple=meanMAPQ/60</text>')
    return (f'<svg width="{width}" height="{height + 20}" '
            f'viewBox="0 -20 {width} {height + 20}" '
            f'xmlns="http://www.w3.org/2000/svg">{legend}'
            f'{"".join(panels)}</svg>')
