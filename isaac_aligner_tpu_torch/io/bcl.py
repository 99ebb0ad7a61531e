"""BCL run-folder data source: RunInfo.xml, per-cycle BCL tiles, filter
files, cluster positions (locs/clocs), and the NextSeq bgzf-aggregated
layout.

The port's own copy of `isaac_aligner_tpu/io/bcl.py`, unchanged apart from
`write_clocs`, a writer of the .clocs format that the fixtures use.

Reference analogs:
  - rta::RunInfoXml                 src/c++/include/rta/RunInfoXml.hh
  - rta::BclMapper/BclReader        src/c++/include/rta/BclMapper.hh:52-284
  - io::FiltersMapper               src/c++/include/io/FiltersMapper.hh:31
  - io::LocsMapper / ClocsMapper    src/c++/include/io/{Locs,Clocs}Mapper.hh
  - BclSeedSource / BclBgzfSeedSource
        src/c++/include/workflow/alignWorkflow/Bcl{,Bgzf}DataSource.hh

File formats (Illumina RTA):
  BCL    uint32le cluster count, then 1 byte/cluster:
         0x00 => N with Q0, else base = bits 0-1 (ACGT), qual = bits 2-7.
         May be gzip- or bgzf-compressed (.bcl.gz / .bcl.bgzf): both are
         RFC-1952 streams, readable with the gzip module.
  filter uint32le 0, uint32le version(3), uint32le count, 1 byte/cluster
         (bit 0 = pass filter).
  locs   uint32le 1, float32le 1.0, uint32le count, then float32le (x,y)
         per cluster.
  clocs  uint8 version(1), uint32le bin count, then per 25x25-unit bin:
         uint8 cluster count + (uint8 dx, uint8 dy) per cluster, bins in
         rows of 82 (2048-unit image width), coords in 1/10 units.
  bci    (NextSeq lane index) uint32le (tile, cluster count) pairs.

Coordinates are reported as the CASAVA/iSAAC integer convention
round(10*value + 1000) used for read names and ZX/ZY tags.

Everything is decoded with vectorized numpy over whole tiles — per-cycle
byte planes land directly in the [clusters, cycles] uint8 arrays the
aligner consumes.  Decoding stays on the host: the card sees only the
decoded batches.
"""

from __future__ import annotations

import dataclasses
import gzip
import struct
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np

from .fastq import ReadBatch

# byte 0 in a BCL means "no call": base N, quality 0
_N_CODE = 4


@dataclasses.dataclass(frozen=True)
class ReadSegment:
    """One <Read> of RunInfo.xml: a read or index segment of the cluster."""

    number: int
    num_cycles: int
    is_indexed: bool


@dataclasses.dataclass
class RunInfo:
    flowcell: str
    instrument: str
    run_number: int
    reads: list[ReadSegment]
    lane_count: int

    @property
    def total_cycles(self) -> int:
        return sum(r.num_cycles for r in self.reads)

    def cycle_ranges(self) -> list[tuple[ReadSegment, int, int]]:
        """[(segment, first_cycle, last_cycle)] with 1-based inclusive cycles."""
        out, start = [], 1
        for r in self.reads:
            out.append((r, start, start + r.num_cycles - 1))
            start += r.num_cycles
        return out

    @property
    def data_reads(self) -> list[ReadSegment]:
        return [r for r in self.reads if not r.is_indexed]

    @property
    def index_reads(self) -> list[ReadSegment]:
        return [r for r in self.reads if r.is_indexed]


def parse_run_info(path: str | Path) -> RunInfo:
    """Parse <run folder>/RunInfo.xml (rta::RunInfoXml)."""
    path = Path(path)
    if path.is_dir():
        path = path / "RunInfo.xml"
    root = ET.parse(path).getroot()
    run = root.find("Run")
    if run is None:
        raise ValueError(f"{path}: no <Run> element")
    reads = []
    reads_el = run.find("Reads")
    for el in (reads_el if reads_el is not None else []):
        reads.append(ReadSegment(
            number=int(el.get("Number", len(reads) + 1)),
            num_cycles=int(el.get("NumCycles")),
            is_indexed=el.get("IsIndexedRead", "N").upper() == "Y"))
    if not reads:
        raise ValueError(f"{path}: no <Read> elements")
    layout = run.find("FlowcellLayout")
    lane_count = int(layout.get("LaneCount", 1)) if layout is not None else 1
    instrument = (run.findtext("Instrument") or "UNKNOWN").strip()
    flowcell = (run.findtext("Flowcell") or "FLOWCELL").strip()
    return RunInfo(flowcell=flowcell, instrument=instrument,
                   run_number=int(run.get("Number", 1)),
                   reads=reads, lane_count=lane_count)


def write_run_info(run_folder: str | Path, info: RunInfo) -> None:
    run = ET.Element("Run", Id=f"{info.instrument}_{info.run_number}_{info.flowcell}",
                     Number=str(info.run_number))
    ET.SubElement(run, "Flowcell").text = info.flowcell
    ET.SubElement(run, "Instrument").text = info.instrument
    reads = ET.SubElement(run, "Reads")
    for r in info.reads:
        ET.SubElement(reads, "Read", Number=str(r.number),
                      NumCycles=str(r.num_cycles),
                      IsIndexedRead="Y" if r.is_indexed else "N")
    ET.SubElement(run, "FlowcellLayout", LaneCount=str(info.lane_count),
                  SurfaceCount="1", SwathCount="1", TileCount="1")
    root = ET.Element("RunInfo", Version="2")
    root.append(run)
    Path(run_folder).mkdir(parents=True, exist_ok=True)
    ET.ElementTree(root).write(Path(run_folder) / "RunInfo.xml",
                               encoding="utf-8", xml_declaration=True)


# --------------------------------------------------------------------------
# low-level codecs
# --------------------------------------------------------------------------

def _read_maybe_gzip(path: Path) -> bytes:
    raw = path.read_bytes()
    if raw[:2] == b"\x1f\x8b":
        return gzip.decompress(raw)
    return raw


def read_bcl(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """One cycle, one tile -> (base codes 0..4, quals) uint8 arrays."""
    data = _read_maybe_gzip(Path(path))
    (count,) = struct.unpack_from("<I", data, 0)
    payload = np.frombuffer(data, np.uint8, count=count, offset=4)
    bases = (payload & 3).astype(np.uint8)
    quals = (payload >> 2).astype(np.uint8)
    no_call = payload == 0
    bases[no_call] = _N_CODE
    return bases, quals


def write_bcl(path: str | Path, bases: np.ndarray, quals: np.ndarray) -> None:
    """Inverse of read_bcl. N bases (code>=4) or Q0 become the 0x00 no-call."""
    bases = np.asarray(bases, np.uint8)
    quals = np.asarray(quals, np.uint8)
    byte = ((quals << 2) | (bases & 3)).astype(np.uint8)
    byte[(bases >= _N_CODE) | (quals == 0)] = 0
    path = Path(path)
    payload = struct.pack("<I", len(byte)) + byte.tobytes()
    if path.suffix in (".gz", ".bgzf"):
        payload = gzip.compress(payload, compresslevel=1)
    path.write_bytes(payload)


def read_filter(path: str | Path) -> np.ndarray:
    """Pass-filter flags -> bool [clusters] (io::FiltersMapper)."""
    data = _read_maybe_gzip(Path(path))
    zero, version = struct.unpack_from("<II", data, 0)
    if zero == 0 and version == 3:
        (count,) = struct.unpack_from("<I", data, 8)
        payload = np.frombuffer(data, np.uint8, count=count, offset=12)
    else:
        # version-0 layout: uint32 count, then bytes
        count = zero
        payload = np.frombuffer(data, np.uint8, count=count, offset=4)
    return (payload & 1).astype(bool)


def write_filter(path: str | Path, pf: np.ndarray) -> None:
    pf = np.asarray(pf).astype(np.uint8)
    Path(path).write_bytes(struct.pack("<III", 0, 3, len(pf)) + pf.tobytes())


def _coord_to_int(v: np.ndarray) -> np.ndarray:
    """CASAVA convention: int(round(10*x + 1000)) — what iSAAC writes to
    read names and ZX/ZY tags (io::LocsMapper)."""
    return np.round(10.0 * v + 1000.0).astype(np.int32)


def read_locs(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """.locs -> (x, y) int32 arrays in CASAVA integer units."""
    data = _read_maybe_gzip(Path(path))
    (count,) = struct.unpack_from("<I", data, 8)
    xy = np.frombuffer(data, "<f4", count=2 * count, offset=12).reshape(-1, 2)
    return _coord_to_int(xy[:, 0]), _coord_to_int(xy[:, 1])


def write_locs(path: str | Path, x: np.ndarray, y: np.ndarray) -> None:
    """x/y given as raw float coordinates (not CASAVA ints)."""
    xy = np.stack([np.asarray(x, np.float32), np.asarray(y, np.float32)], 1)
    Path(path).write_bytes(struct.pack("<IfI", 1, 1.0, xy.shape[0]) +
                           xy.astype("<f4").tobytes())


_CLOCS_BLOCK_UNITS = 25          # bin edge length in coordinate units
_CLOCS_BLOCKS_PER_ROW = 82       # 2048-unit image width / 25, rounded up


def read_clocs(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """.clocs -> (x, y) int32 CASAVA units (io::ClocsMapper)."""
    data = _read_maybe_gzip(Path(path))
    n_bins = struct.unpack_from("<I", data, 1)[0]
    off = 5
    xs, ys = [], []
    for b in range(n_bins):
        n = data[off]
        off += 1
        if n:
            pairs = np.frombuffer(data, np.uint8, count=2 * n, offset=off)
            off += 2 * n
            dx = pairs[0::2].astype(np.float64) / 10.0
            dy = pairs[1::2].astype(np.float64) / 10.0
            bx = (b % _CLOCS_BLOCKS_PER_ROW) * _CLOCS_BLOCK_UNITS
            by = (b // _CLOCS_BLOCKS_PER_ROW) * _CLOCS_BLOCK_UNITS
            xs.append(bx + dx)
            ys.append(by + dy)
    if not xs:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    return (_coord_to_int(np.concatenate(xs)), _coord_to_int(np.concatenate(ys)))


def write_clocs(path: str | Path, x: np.ndarray, y: np.ndarray) -> None:
    """Inverse of read_clocs for raw float coordinates (not CASAVA ints):
    each cluster lands in its 25x25-unit bin with (dx, dy) rounded to
    1/10 unit.  Clusters must come in bin order (row-major over rows of
    82 bins), as the format stores them."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    bx = np.floor(x / _CLOCS_BLOCK_UNITS).astype(np.int64)
    by = np.floor(y / _CLOCS_BLOCK_UNITS).astype(np.int64)
    if ((bx < 0) | (by < 0) | (bx >= _CLOCS_BLOCKS_PER_ROW)).any():
        raise ValueError("clocs coordinates outside the 2048-unit image")
    bins = by * _CLOCS_BLOCKS_PER_ROW + bx
    if (np.diff(bins) < 0).any():
        raise ValueError("clocs clusters must come in bin order")
    dx = np.round((x - bx * _CLOCS_BLOCK_UNITS) * 10.0).astype(np.int64)
    dy = np.round((y - by * _CLOCS_BLOCK_UNITS) * 10.0).astype(np.int64)
    if ((dx > 255) | (dy > 255)).any():
        raise ValueError("clocs offsets exceed one byte")
    n_bins = int(bins[-1]) + 1 if bins.size else 0
    counts = np.bincount(bins, minlength=n_bins)
    if (counts > 255).any():
        raise ValueError("more than 255 clusters in one clocs bin")
    # per bin: its count byte, then its clusters' (dx, dy) byte pairs
    out = np.zeros(n_bins + 2 * x.size, np.uint8)
    starts = np.arange(n_bins) + 2 * (np.cumsum(counts) - counts)
    out[starts] = counts
    rank = np.arange(x.size) - (np.cumsum(counts) - counts)[bins]
    at = starts[bins] + 1 + 2 * rank
    out[at] = dx
    out[at + 1] = dy
    Path(path).write_bytes(bytes([1]) + struct.pack("<I", n_bins)
                           + out.tobytes())


# --------------------------------------------------------------------------
# run-folder layout + tile loading
# --------------------------------------------------------------------------

def _basecalls_dir(run_folder: Path) -> Path:
    return run_folder / "Data" / "Intensities" / "BaseCalls"


def _intensities_dir(run_folder: Path) -> Path:
    return run_folder / "Data" / "Intensities"


def discover_tiles(run_folder: str | Path, lane: int) -> list[int]:
    """Tile numbers present for a lane (TileSource::discoverTiles)."""
    lane_dir = _basecalls_dir(Path(run_folder)) / f"L{lane:03d}"
    c1 = lane_dir / "C1.1"
    if c1.is_dir():
        tiles = set()
        for f in c1.iterdir():
            name = f.name
            for suffix in (".bcl.bgzf", ".bcl.gz", ".bcl"):
                if name.endswith(suffix):
                    # s_<lane>_<tile><suffix>
                    tiles.add(int(name[: -len(suffix)].split("_")[2]))
                    break
        return sorted(tiles)
    # NextSeq bgzf-aggregated layout: tiles listed in the lane bci
    bci = lane_dir / f"s_{lane}.bci"
    if bci.exists():
        pairs = np.frombuffer(bci.read_bytes(), "<u4").reshape(-1, 2)
        return [int(t) for t in pairs[:, 0]]
    raise FileNotFoundError(f"no BCL tiles for lane {lane} under {lane_dir}")


def discover_lanes(run_folder: str | Path) -> list[int]:
    base = _basecalls_dir(Path(run_folder))
    lanes = []
    for d in sorted(base.glob("L[0-9][0-9][0-9]")):
        lanes.append(int(d.name[1:]))
    return lanes


def _find_tile_file(dir_: Path, stem: str, exts: tuple[str, ...]) -> Path | None:
    for ext in exts:
        p = dir_ / (stem + ext)
        if p.exists():
            return p
    return None


def _lane_bci(lane_dir: Path, lane: int) -> np.ndarray:
    bci = lane_dir / f"s_{lane}.bci"
    return np.frombuffer(bci.read_bytes(), "<u4").reshape(-1, 2)


@dataclasses.dataclass
class TileData:
    """Everything decoded for one (lane, tile): the reference's unit of
    batch processing (flowcell::TileMetadata + BclClusters)."""

    lane: int
    tile: int
    # per data-read segment, in RunInfo order: uint8 [clusters, cycles]
    read_bases: list[np.ndarray]
    read_quals: list[np.ndarray]
    # concatenated index-read bases (for BarcodeResolver); [clusters, 0] if none
    barcode_bases: np.ndarray
    pf: np.ndarray        # bool [clusters]
    x: np.ndarray         # int32 [clusters] CASAVA units (0 if no locs)
    y: np.ndarray

    @property
    def cluster_count(self) -> int:
        return int(self.pf.shape[0])


def load_tile(run_folder: str | Path, lane: int, tile: int,
              info: RunInfo | None = None,
              use_bases_mask: str | None = None,
              max_workers: int = 8,
              ignore_missing_bcls: bool = False,
              ignore_missing_filters: bool = False) -> TileData:
    """Decode the needed cycles of one tile (rta::BclMapper + FiltersMapper +
    LocsMapper in one pass).

    `use_bases_mask` follows the reference --use-bases-mask grammar
    (io/use_bases_mask.py); masked-out ('n') cycles are never read from
    disk.  Cycle files load on a thread pool (rta::ParallelBclMapper).
    Graceful degradation (reference --ignore-missing-bcls/-filters,
    manual.md:397-400): missing cycle files become all-N / q0 planes,
    missing filter files all-pass — only when the matching flag is set.
    """
    from .use_bases_mask import effective_segments

    run_folder = Path(run_folder)
    info = info or parse_run_info(run_folder)
    lane_dir = _basecalls_dir(run_folder) / f"L{lane:03d}"

    segments = effective_segments(info, use_bases_mask)
    needed = sorted({c for _, cycles in segments for c in cycles})

    lane_slice = None   # (lo, hi) cluster range in per-lane aggregate files
    per_cycle_dirs = (lane_dir / "C1.1").is_dir()
    if per_cycle_dirs:
        def fetch(cycle0: int):
            cycle = cycle0 + 1
            f = _find_tile_file(lane_dir / f"C{cycle}.1", f"s_{lane}_{tile}",
                                (".bcl", ".bcl.gz", ".bcl.bgzf"))
            if f is None:
                if ignore_missing_bcls:
                    return None   # filled with N/q0 once the count is known
                raise FileNotFoundError(
                    f"missing BCL for lane {lane} tile {tile} cycle {cycle}")
            return read_bcl(f)
    else:
        # NextSeq: one bgzf per cycle holding all tiles, sliced via lane bci
        pairs = _lane_bci(lane_dir, lane)
        tiles = [int(t) for t in pairs[:, 0]]
        if tile not in tiles:
            raise FileNotFoundError(f"tile {tile} not in lane {lane} bci")
        ti = tiles.index(tile)
        lo = int(pairs[:ti, 1].sum())
        hi = lo + int(pairs[ti, 1])
        lane_slice = (lo, hi)

        def fetch(cycle0: int):
            cycle = cycle0 + 1
            f = _find_tile_file(lane_dir, f"{cycle:04d}",
                                (".bcl.bgzf", ".bcl.gz", ".bcl"))
            if f is None:
                if ignore_missing_bcls:
                    return None
                raise FileNotFoundError(f"missing cycle {cycle} BCL in {lane_dir}")
            b, q = read_bcl(f)
            return b[lo:hi], q[lo:hi]

    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        planes = dict(zip(needed, pool.map(fetch, needed)))

    present = [c for c in needed if planes[c] is not None]
    if not present:
        raise FileNotFoundError(
            f"no BCL cycle files at all for lane {lane} tile {tile}")
    count = len(planes[present[0]][0])
    for c in needed:
        if planes[c] is None:   # --ignore-missing-bcls: all-N, quality 0
            planes[c] = (np.full(count, _N_CODE, np.uint8),
                         np.zeros(count, np.uint8))
        if len(planes[c][0]) != count:
            raise ValueError(
                f"cycle {c + 1}: cluster count {len(planes[c][0])} != {count}")

    read_bases, read_quals, index_parts = [], [], []
    for is_indexed, cycles in segments:
        b = np.stack([planes[c][0] for c in cycles], axis=1)
        if is_indexed:
            index_parts.append(b)
        else:
            read_bases.append(b)
            read_quals.append(np.stack([planes[c][1] for c in cycles], axis=1))
    barcode = (np.concatenate(index_parts, axis=1) if index_parts
               else np.zeros((count, 0), np.uint8))

    pf_file = _find_tile_file(lane_dir, f"s_{lane}_{tile}",
                              (".filter",)) or _find_tile_file(
        _intensities_dir(run_folder) / f"L{lane:03d}", f"s_{lane}_{tile}", (".filter",))
    if pf_file:
        pf = read_filter(pf_file)
    elif lane_slice and (lane_dir / f"s_{lane}.filter").exists():
        # NextSeq: one per-lane filter covering all tiles, sliced via bci
        pf = read_filter(lane_dir / f"s_{lane}.filter")[lane_slice[0]:lane_slice[1]]
    elif ignore_missing_filters:
        # reference --ignore-missing-filters: all clusters pass
        pf = np.ones(count, bool)
    else:
        raise FileNotFoundError(
            f"missing filter file for lane {lane} tile {tile} "
            f"(pass --ignore-missing-filters to treat all clusters as PF)")
    if len(pf) != count:
        raise ValueError(f"filter count {len(pf)} != cluster count {count}")

    pos_dir = _intensities_dir(run_folder) / f"L{lane:03d}"
    # no position files: synthesize unique coordinates (cluster ordinal) —
    # read names must stay distinct for demultiplexing and pairing
    x = np.arange(count, dtype=np.int32)
    y = np.zeros(count, np.int32)
    locs = _find_tile_file(pos_dir, f"s_{lane}_{tile}", (".locs",))
    clocs = _find_tile_file(pos_dir, f"s_{lane}_{tile}", (".clocs",))
    if locs:
        x, y = read_locs(locs)
    elif clocs:
        x, y = read_clocs(clocs)
    if len(x) != count:
        raise ValueError(f"positions count {len(x)} != cluster count {count}")

    return TileData(lane=lane, tile=tile, read_bases=read_bases,
                    read_quals=read_quals, barcode_bases=barcode,
                    pf=pf, x=x, y=y)


def tile_read_batches(td: TileData, info: RunInfo,
                      pf_only: bool = True) -> tuple[list[ReadBatch], np.ndarray]:
    """TileData -> one ReadBatch per data read (+ filtered barcode array).

    Read names follow the Illumina convention
    <instrument>:<run>:<flowcell>:<lane>:<tile>:<x>:<y> so that pairs share
    a name and ZX/ZY survive into tags.
    """
    keep = td.pf if pf_only else np.ones(td.cluster_count, bool)
    idx = np.nonzero(keep)[0]
    names = [f"{info.instrument}:{info.run_number}:{info.flowcell}:"
             f"{td.lane}:{td.tile}:{td.x[i]}:{td.y[i]}" for i in idx]
    batches = []
    for bases, quals in zip(td.read_bases, td.read_quals):
        b = bases[idx]
        q = quals[idx].copy()
        q[b >= _N_CODE] = 0
        lengths = np.full(len(idx), b.shape[1], np.int32)
        batches.append(ReadBatch(names=list(names), bases=b, quals=q,
                                 lengths=lengths))
    return batches, td.barcode_bases[idx]


def load_run_reads(run_folder: str | Path, lanes: list[int] | None = None,
                   tiles: list[int] | None = None, pf_only: bool = True,
                   use_bases_mask: str | None = None,
                   ignore_missing_bcls: bool = False,
                   ignore_missing_filters: bool = False
                   ) -> tuple[ReadBatch, ReadBatch | None, np.ndarray]:
    """Whole-run loader: concatenates every (lane, tile) into flat
    read1/read2 batches + observed barcode codes (BclSeedSource analog).
    """
    run_folder = Path(run_folder)
    info = parse_run_info(run_folder)
    lanes = lanes or discover_lanes(run_folder)
    parts1, parts2, bars = [], [], []
    for lane in lanes:
        for tile in (tiles or discover_tiles(run_folder, lane)):
            td = load_tile(run_folder, lane, tile, info,
                           use_bases_mask=use_bases_mask,
                           ignore_missing_bcls=ignore_missing_bcls,
                           ignore_missing_filters=ignore_missing_filters)
            batches, bar = tile_read_batches(td, info, pf_only)
            if not batches:
                raise ValueError(f"{run_folder}: no data reads in RunInfo")
            if len(batches) > 2:
                raise ValueError("more than 2 data reads not supported")
            parts1.append(batches[0])
            if len(batches) > 1:
                parts2.append(batches[1])
            bars.append(bar)
    b1 = _concat_batches(parts1)
    b2 = _concat_batches(parts2) if parts2 else None
    return b1, b2, np.concatenate(bars, axis=0)


def _concat_batches(parts: list[ReadBatch]) -> ReadBatch:
    names: list[str] = []
    for p in parts:
        names.extend(p.names)
    return ReadBatch(names=names,
                     bases=np.concatenate([p.bases for p in parts]),
                     quals=np.concatenate([p.quals for p in parts]),
                     lengths=np.concatenate([p.lengths for p in parts]))


# --------------------------------------------------------------------------
# run-folder synthesis (tests + tooling; reference has no writer)
# --------------------------------------------------------------------------

def write_run_folder(run_folder: str | Path, info: RunInfo, lane: int,
                     tile: int, segments: list[tuple[np.ndarray, np.ndarray]],
                     pf: np.ndarray | None = None,
                     x: np.ndarray | None = None,
                     y: np.ndarray | None = None,
                     compress: bool = False) -> None:
    """Write one tile of a synthetic run folder.

    segments: per RunInfo read segment (data AND index, in order), a
    (bases uint8 [clusters, cycles], quals uint8) pair.
    """
    run_folder = Path(run_folder)
    write_run_info(run_folder, info)
    if len(segments) != len(info.reads):
        raise ValueError("one (bases, quals) pair per RunInfo read required")
    count = segments[0][0].shape[0]
    lane_dir = _basecalls_dir(run_folder) / f"L{lane:03d}"
    ext = ".bcl.gz" if compress else ".bcl"
    for (seg, first, _last), (bases, quals) in zip(info.cycle_ranges(), segments):
        if bases.shape != (count, seg.num_cycles):
            raise ValueError(f"segment {seg.number}: shape {bases.shape} != "
                             f"({count}, {seg.num_cycles})")
        for c in range(seg.num_cycles):
            cycle = first + c
            cdir = lane_dir / f"C{cycle}.1"
            cdir.mkdir(parents=True, exist_ok=True)
            write_bcl(cdir / f"s_{lane}_{tile}{ext}", bases[:, c], quals[:, c])
    if pf is None:
        pf = np.ones(count, bool)
    write_filter(lane_dir / f"s_{lane}_{tile}.filter", pf)
    pos_dir = _intensities_dir(run_folder) / f"L{lane:03d}"
    pos_dir.mkdir(parents=True, exist_ok=True)
    if x is None:
        x = np.arange(count, dtype=np.float32)
        y = np.zeros(count, np.float32)
    write_locs(pos_dir / f"s_{lane}_{tile}.locs", x, y)


def write_run_folder_bgzf(run_folder: str | Path, info: RunInfo, lane: int,
                          tiles: list[tuple[int, list[tuple[np.ndarray, np.ndarray]]]],
                          ) -> None:
    """Write the NextSeq bgzf-aggregated layout: one <cycle>.bcl.bgzf per
    cycle holding every tile's clusters back to back, plus the s_<lane>.bci
    tile index (BclBgzfSeedSource analog).

    tiles: [(tile_number, segments)] where segments matches
    write_run_folder's convention.
    """
    run_folder = Path(run_folder)
    write_run_info(run_folder, info)
    lane_dir = _basecalls_dir(run_folder) / f"L{lane:03d}"
    lane_dir.mkdir(parents=True, exist_ok=True)
    counts = [segs[0][0].shape[0] for _t, segs in tiles]
    bci = np.array([[t, c] for (t, _s), c in zip(tiles, counts)],
                   np.uint32)
    (lane_dir / f"s_{lane}.bci").write_bytes(bci.astype("<u4").tobytes())
    for (seg_i, (seg, first, _last)) in enumerate(info.cycle_ranges()):
        for c in range(seg.num_cycles):
            cycle = first + c
            bases = np.concatenate(
                [segs[seg_i][0][:, c] for _t, segs in tiles])
            quals = np.concatenate(
                [segs[seg_i][1][:, c] for _t, segs in tiles])
            write_bcl(lane_dir / f"{cycle:04d}.bcl.bgzf", bases, quals)
    total = int(sum(counts))
    write_filter(lane_dir / f"s_{lane}.filter", np.ones(total, bool))


def peek_tile_cluster_count(run_folder: str | Path, lane: int,
                            tile: int) -> int:
    """Cluster count of one tile WITHOUT loading base planes (filter/BCL
    headers only) — used to size genomic bins before streaming."""
    run_folder = Path(run_folder)
    lane_dir = _basecalls_dir(run_folder) / f"L{lane:03d}"
    f = _find_tile_file(lane_dir, f"s_{lane}_{tile}", (".filter",))
    if f:
        return int(read_filter(f).shape[0])
    if (lane_dir / "C1.1").is_dir():
        b = _find_tile_file(lane_dir / "C1.1", f"s_{lane}_{tile}",
                            (".bcl", ".bcl.gz", ".bcl.bgzf"))
        if b is None:
            raise FileNotFoundError(f"no cycle-1 BCL for tile {tile}")
        import gzip
        opener = gzip.open if b.suffix in (".gz", ".bgzf") else open
        with opener(b, "rb") as fh:
            return struct.unpack("<I", fh.read(4))[0]
    # NextSeq aggregated layout: per-lane bci holds per-tile counts
    pairs = _lane_bci(lane_dir, lane)
    for t, n in pairs:
        if int(t) == tile:
            return int(n)
    raise FileNotFoundError(f"tile {tile} not in lane {lane} bci")
