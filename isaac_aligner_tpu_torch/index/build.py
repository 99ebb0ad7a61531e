"""Sorted k-mer seed index: build, save and load (host, numpy).

The port's own copy of the parts of `isaac_aligner_tpu/index/build.py` that
it calls, unchanged, with the same on-disk layout: an index directory
written by either package loads in the other.  Reference analog:
ReferenceSorter (src/c++/lib/reference/ReferenceSorter.cpp:77-260) and the
on-disk ReferenceKmer record (src/c++/include/reference/ReferenceKmer.hh).

- The index is a flat, fully sorted array of (k-mer, position) records held
  as three int32 planes: `key_hi`, `key_lo` (bias-encoded so that signed
  int32 comparison matches unsigned 2-bit lexicographic k-mer order) and
  `pos` (flat global genome position).
- Only forward-strand genome k-mers are stored; reads contribute both
  forward and reverse-complement seeds at query time.
- K-mers occurring more often than `repeat_threshold` collapse into one
  record with position sentinel TOO_MANY_POS (the reference's
  TooManyMatch, src/c++/include/reference/ReferencePosition.hh:55-75).
- Seed lengths 16 (key_lo == 0), 32 and 64 (two extra `key_mids`
  planes) build, save and load; the port's pipeline refuses 64-mer
  indexes (ROADMAP queue A).
- `annotate_neighbors` sets the per-record "has <=4-mismatch neighbors"
  bit (`index/neighbors.py`; the device program runs on `device`, "cuda"
  by default).
- `build_index_streaming` is the bounded-memory external radix build,
  byte-identical to `build_index` + `save`.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import tempfile
from pathlib import Path

import numpy as np

from .. import dna
from ..io.fasta import ContigMeta, Genome

#: position sentinel for repeat-collapsed k-mers
TOO_MANY_POS = np.int32(-1)

_BIAS = np.uint32(1 << 31)


def bias_u32_to_i32(x: np.ndarray) -> np.ndarray:
    """Map uint32 onto int32 preserving order: u < v  <=>  bias(u) < bias(v)."""
    return (np.asarray(x, dtype=np.uint32) ^ _BIAS).view(np.int32)


def unbias_i32_to_u32(x: np.ndarray) -> np.ndarray:
    return (np.asarray(x, dtype=np.int32).view(np.uint32) ^ _BIAS)


@dataclasses.dataclass
class SeedIndex:
    """Host-side sorted seed index (`align.pipeline.prepare_index` uploads it)."""

    seed_len: int
    repeat_threshold: int
    genome: Genome
    key_hi: np.ndarray        # int32 [Nk] biased, sorted lexicographically with key_lo
    key_lo: np.ndarray        # int32 [Nk] biased
    pos: np.ndarray           # int32 [Nk] global genome position, or TOO_MANY_POS
    total_kmers: int          # k-mer instances before repeat collapse
    collapsed_kmers: int      # distinct k-mers collapsed as too-repetitive
    # per-record "has <=4-mismatch neighbors" bit; zeros when not annotated
    has_neighbors: np.ndarray | None = None
    # 64-mer LongKmerType middle words, biased int32; empty for 16/32-mer
    key_mids: tuple = ()

    @property
    def num_records(self) -> int:
        return int(self.key_hi.shape[0])

    @staticmethod
    def from_arrays(*, seed_len: int, repeat_threshold: int,
                    genome_codes: np.ndarray, contigs, key_hi: np.ndarray,
                    key_lo: np.ndarray, pos: np.ndarray, total_kmers: int,
                    collapsed_kmers: int, has_neighbors=None,
                    key_mids=()) -> "SeedIndex":
        """An index from plain fields: the record planes as numpy arrays and
        `contigs` as dicts of index/name/offset/length/md5 (the
        `sorted-reference.json` entries), e.g. carried across from an index
        built elsewhere."""
        genome = Genome(codes=np.asarray(genome_codes, np.uint8),
                        contigs=[ContigMeta(**c) for c in contigs])
        return SeedIndex(
            seed_len=int(seed_len), repeat_threshold=int(repeat_threshold),
            genome=genome, key_hi=np.asarray(key_hi, np.int32),
            key_lo=np.asarray(key_lo, np.int32), pos=np.asarray(pos, np.int32),
            total_kmers=int(total_kmers), collapsed_kmers=int(collapsed_kmers),
            has_neighbors=(None if has_neighbors is None
                           else np.asarray(has_neighbors)),
            key_mids=tuple(np.asarray(m, np.int32) for m in key_mids))

    # -- persistence (JSON metadata + raw npy, replacing sorted-reference.xml,
    #    reference: src/c++/lib/reference/SortedReferenceXml.cpp) ------------

    def save(self, directory: str | Path) -> None:
        d = Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        np.save(d / "key_hi.npy", self.key_hi)
        np.save(d / "key_lo.npy", self.key_lo)
        for i, m in enumerate(self.key_mids):
            np.save(d / f"key_m{i + 1}.npy", m)
        np.save(d / "pos.npy", self.pos)
        np.save(d / "genome.npy", self.genome.codes)
        if self.has_neighbors is not None:
            np.save(d / "neighbors.npy", self.has_neighbors)
        meta = {
            "format_version": 1,
            "seed_len": self.seed_len,
            "repeat_threshold": self.repeat_threshold,
            "total_kmers": self.total_kmers,
            "collapsed_kmers": self.collapsed_kmers,
            "contigs": [
                {"index": c.index, "name": c.name, "offset": c.offset,
                 "length": c.length, "md5": c.md5}
                for c in self.genome.contigs
            ],
        }
        meta.update(self._write_prepared_cache(d))
        (d / "sorted-reference.json").write_text(json.dumps(meta, indent=2))

    def _write_prepared_cache(self, d: Path) -> dict:
        """Precompute the device-upload-ready planes (packed genome,
        bucket table) so align runs mmap them instead of re-deriving."""
        from ..align.pipeline import _cached_bucket_table, pack_genome
        packed, nbits = pack_genome(self.genome.codes)
        np.save(d / "genome_packed.npy", packed)
        np.save(d / "genome_nbits.npy", nbits)
        starts, width, log2 = _cached_bucket_table(self)
        np.save(d / "bucket_starts.npy", starts)
        return {"bucket_width": width, "bucket_log2": log2,
                "genome_has_n": bool((self.genome.codes >= dna.NUM_BASES).any())}

    def load_prepared_cache(self, d: Path, meta: dict) -> None:
        """Attach mmapped prepared planes saved by `_write_prepared_cache`
        (no-op for pre-cache index directories — they re-derive)."""
        if "bucket_width" not in meta or not (d / "genome_packed.npy").exists():
            return
        starts = np.load(d / "bucket_starts.npy", mmap_mode="r")
        self._bucket_table = (starts, meta["bucket_width"],
                              meta["bucket_log2"])
        self._packed_planes = (
            np.load(d / "genome_packed.npy", mmap_mode="r"),
            np.load(d / "genome_nbits.npy", mmap_mode="r"))
        self._has_n = meta["genome_has_n"]

    @staticmethod
    def load(directory: str | Path, mmap: bool = False) -> "SeedIndex":
        """Load a saved index; ``mmap=True`` memory-maps the record planes
        (bounded host RAM for human-scale indexes)."""
        d = Path(directory)
        mode = "r" if mmap else None
        meta = json.loads((d / "sorted-reference.json").read_text())
        contigs = [ContigMeta(**c) for c in meta["contigs"]]
        genome = Genome(codes=np.load(d / "genome.npy"), contigs=contigs)
        mids = []
        for i in (1, 2):
            p = d / f"key_m{i}.npy"
            if p.exists():
                mids.append(np.load(p, mmap_mode=mode))
        index = SeedIndex(
            seed_len=meta["seed_len"],
            repeat_threshold=meta["repeat_threshold"],
            genome=genome,
            key_hi=np.load(d / "key_hi.npy", mmap_mode=mode),
            key_lo=np.load(d / "key_lo.npy", mmap_mode=mode),
            key_mids=tuple(mids),
            pos=np.load(d / "pos.npy", mmap_mode=mode),
            total_kmers=meta["total_kmers"],
            collapsed_kmers=meta["collapsed_kmers"],
            has_neighbors=(np.load(d / "neighbors.npy", mmap_mode=mode)
                           if (d / "neighbors.npy").exists() else None),
        )
        index.load_prepared_cache(d, meta)
        return index


def _rolling_kmers_u32(codes: np.ndarray, start: int, k: int, n_windows: int) -> np.ndarray:
    """value[p] = 2-bit big-endian pack of codes[p+start : p+start+k], vectorized."""
    v = np.zeros(n_windows, dtype=np.uint32)
    for j in range(k):
        v = (v << np.uint32(2)) | codes[start + j : start + j + n_windows].astype(np.uint32)
    return v


def build_index(
    genome: Genome,
    seed_len: int = 32,
    repeat_threshold: int = 1000,
    annotate_neighbors: bool = False,
    device="cuda",
) -> SeedIndex:
    """Build the sorted (k-mer, position) index over all contigs.

    Vectorized host build. Excluded windows: any containing an ambiguous
    base, and any crossing a contig boundary (reference excludes these the
    same way by streaming per-contig).  `annotate_neighbors` runs the
    neighbor annotation on `device`.
    """
    if seed_len not in (16, 32, 64):
        raise ValueError("seed_len must be 16, 32 or 64")
    codes = genome.codes
    g = codes.shape[0]
    if g >= 2**31:
        raise ValueError("single index shard addresses < 2^31 bases; shard the genome")
    n_windows = g - seed_len + 1
    if n_windows <= 0:
        raise ValueError("genome shorter than seed length")

    # window validity: no N, single contig
    is_n = (codes >= dna.NUM_BASES).astype(np.int64)
    cs = np.concatenate([[0], np.cumsum(is_n)])
    n_in_window = cs[seed_len:] - cs[:-seed_len]          # [n_windows]
    valid = n_in_window == 0
    for c in genome.contigs:
        # windows starting in the last seed_len-1 bases of a contig cross into
        # the next contig (or run off the end) — drop them
        tail_start = max(c.offset, c.end - seed_len + 1)
        valid[tail_start : min(c.end, n_windows)] = False

    positions = np.nonzero(valid)[0].astype(np.int32)

    # key words outer->inner: hi, mids..., lo (16 bases each)
    n_words = max(seed_len // 16, 2)
    words = [_rolling_kmers_u32(codes, 16 * w, 16, n_windows)[positions]
             if 16 * (w + 1) <= seed_len else
             np.zeros(positions.shape[0], np.uint32)
             for w in range(n_words)]

    order = np.lexsort((positions, *reversed(words)))
    words = [w[order] for w in words]
    positions = positions[order]
    total = int(positions.shape[0])

    # repeat collapse: group identical k-mers, collapse groups > threshold
    if total:
        new_group = np.empty(total, dtype=bool)
        new_group[0] = True
        diff = words[0][1:] != words[0][:-1]
        for w in words[1:]:
            diff = diff | (w[1:] != w[:-1])
        new_group[1:] = diff
        group_id = np.cumsum(new_group) - 1
        counts = np.bincount(group_id)
        too_many = counts > repeat_threshold              # per group
        keep = ~too_many[group_id]
        # one sentinel record per collapsed group (at the group head)
        sentinel = new_group & too_many[group_id]
        out_mask = keep | sentinel
        out_words = [w[out_mask] for w in words]
        out_pos = np.where(sentinel[out_mask], TOO_MANY_POS, positions[out_mask]).astype(np.int32)
        collapsed = int(too_many.sum())
    else:
        out_words = words
        out_pos = positions
        collapsed = 0

    index = SeedIndex(
        seed_len=seed_len,
        repeat_threshold=repeat_threshold,
        genome=genome,
        key_hi=bias_u32_to_i32(out_words[0]),
        key_lo=bias_u32_to_i32(out_words[-1]),
        key_mids=tuple(bias_u32_to_i32(w) for w in out_words[1:-1]),
        pos=out_pos,
        total_kmers=total,
        collapsed_kmers=collapsed,
    )
    if annotate_neighbors:
        from .neighbors import annotate_index
        index.has_neighbors = annotate_index(
            index.key_hi, index.key_lo, k=seed_len,
            key_mids=tuple(index.key_mids), device=device).astype(np.uint8)
    return index


# ---------------------------------------------------------------------------
# Bounded-memory streaming build (human-scale hosts)
# ---------------------------------------------------------------------------

def _raw_to_npy(raw_path: Path, npy_path: Path, dtype: np.dtype) -> int:
    """Wrap a raw little-endian array file into .npy format by prefixing the
    header and streaming the payload across; returns the element count."""
    itemsize = np.dtype(dtype).itemsize
    nbytes = raw_path.stat().st_size
    assert nbytes % itemsize == 0
    n = nbytes // itemsize
    with open(npy_path, "wb") as out:
        np.lib.format.write_array_header_1_0(
            out, {"descr": np.lib.format.dtype_to_descr(np.dtype(dtype)),
                  "fortran_order": False, "shape": (n,)})
        with open(raw_path, "rb") as src:
            shutil.copyfileobj(src, out, length=1 << 22)
    return int(n)


def _chunk_windows_arrays(codes: np.ndarray, contigs, seed_len: int,
                          start: int, stop: int):
    """(key words outer->inner, pos) of all valid seed windows with start
    in [start, stop).  Words: (hi, lo) for 16/32-mers, (hi, m1, m2, lo)
    for the 64-mer LongKmerType index."""
    span = codes[start : stop + seed_len - 1]
    n_local = stop - start
    is_n = (span >= dna.NUM_BASES).astype(np.int32)
    cs = np.concatenate([np.zeros(1, np.int32), np.cumsum(is_n, dtype=np.int32)])
    valid = (cs[seed_len : seed_len + n_local] - cs[:n_local]) == 0
    for c in contigs:
        tail_start = max(c.offset, c.end - seed_len + 1)
        lo_b, hi_b = max(tail_start, start), min(c.end, stop)
        if lo_b < hi_b:
            valid[lo_b - start : hi_b - start] = False
    local = np.nonzero(valid)[0]
    pos = (local + start).astype(np.int32)
    n_words = max(seed_len // 16, 2)
    words = [_rolling_kmers_u32(span, 16 * w, 16, n_local)[local]
             if 16 * (w + 1) <= seed_len else
             np.zeros(local.shape[0], np.uint32)
             for w in range(n_words)]
    return words, pos


def build_index_streaming(
    genome: Genome,
    out_dir: str | Path,
    seed_len: int = 32,
    repeat_threshold: int = 1000,
    annotate_neighbors: bool = False,
    mask_width: int = 6,
    chunk_windows: int = 1 << 24,
    work_dir: str | Path | None = None,
    device="cuda",
) -> SeedIndex:
    """Bounded-memory index build: external radix sort over k-mer mask bits.

    Reference analog: the per-mask shard build DAG — isaac-sort-reference
    drives 2^maskWidth independent sortReference runs (default maskWidth=6,
    src/make/reference/SortReference.mk:54-84; ReferenceSorter filters the
    genome stream by the k-mer's high mask bits,
    src/c++/lib/reference/ReferenceSorter.cpp:104-176). Same sharding axis
    here, recomposed as a two-pass external sort so one process stays within
    bounded RAM instead of 2^maskWidth genome re-scans:

    1. **Partition pass** — scan the genome in ``chunk_windows`` slabs,
       pack (hi, lo, pos) records for valid windows, append each record to
       its mask bucket file (bucket = top ``mask_width`` bits of the k-mer).
    2. **Per-bucket sort pass** — ascending over buckets: load one bucket
       (~1/2^mask_width of the genome), lexsort by (hi, lo, pos), collapse
       k-mers over ``repeat_threshold`` into one TOO_MANY_POS record
       (identical logic to :func:`build_index`), stream results to the
       final record planes.

    Because a bucket is a prefix of the sort key, bucket-ascending
    concatenation IS the global sort order and no k-mer group spans a
    bucket boundary — output is byte-identical to :func:`build_index`.

    Peak RAM: one genome byte-plane + one chunk (~12B/window) + one sorted
    bucket (~total/2^mask_width records). The finished index is written to
    ``out_dir`` in the standard save() layout; the returned SeedIndex holds
    memory-mapped planes.  `annotate_neighbors` runs the bounded-RAM
    annotation, on `device` for indexes it holds in RAM.
    """
    if seed_len not in (16, 32, 64):
        raise ValueError("seed_len must be 16, 32 or 64")
    if annotate_neighbors and seed_len == 64:
        raise ValueError(
            "neighbor annotation supports 16/32-mer indexes (64-mer "
            "mode: pass --dont-annotate)")
    codes = genome.codes
    g = codes.shape[0]
    if g >= 2**31:
        raise ValueError("single index shard addresses < 2^31 bases; shard the genome")
    n_windows = g - seed_len + 1
    if n_windows <= 0:
        raise ValueError("genome shorter than seed length")
    if not (0 < mask_width <= 16):
        raise ValueError("mask_width must be in (0, 16]")

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    n_buckets = 1 << mask_width
    shift = np.uint32(32 - mask_width)
    n_words = max(seed_len // 16, 2)
    plane_names = (["key_hi"] + [f"key_m{i}" for i in range(1, n_words - 1)]
                   + ["key_lo"])

    with tempfile.TemporaryDirectory(
            dir=str(work_dir) if work_dir else None) as tmp_name:
        tmp = Path(tmp_name)
        bucket_paths = [tmp / f"bucket_{m:05d}.bin" for m in range(n_buckets)]
        # -- pass 1: chunked scan, radix partition by mask bits ------------
        # bucket files open in append mode per chunk (not held across the
        # whole pass): at mask_width 16 the 65536 simultaneous handles +
        # stdio buffers would blow both ulimit -n and the memory bound
        for start in range(0, n_windows, chunk_windows):
            stop = min(start + chunk_windows, n_windows)
            words, pos = _chunk_windows_arrays(codes, genome.contigs,
                                               seed_len, start, stop)
            if pos.shape[0] == 0:
                continue
            bucket = (words[0] >> shift).astype(np.int64)
            order = np.argsort(bucket, kind="stable")
            recs = np.empty((pos.shape[0], n_words + 1), dtype=np.uint32)
            for i, w in enumerate(words):
                recs[:, i] = w[order]
            recs[:, n_words] = pos[order].view(np.uint32)
            bounds = np.searchsorted(bucket[order], np.arange(n_buckets + 1))
            for m in range(n_buckets):
                b, e = bounds[m], bounds[m + 1]
                if e > b:
                    with open(bucket_paths[m], "ab") as f:
                        f.write(recs[b:e].tobytes())

        # -- pass 2: per-bucket sort + repeat collapse -> raw planes -------
        raw = {name: tmp / f"{name}.raw" for name in plane_names + ["pos"]}
        total = 0
        collapsed = 0
        files = {name: open(rp, "wb") for name, rp in raw.items()}
        try:
            for m in range(n_buckets):
                p = bucket_paths[m]
                if not p.exists() or p.stat().st_size == 0:
                    continue
                arr = np.fromfile(p, dtype=np.uint32).reshape(-1, n_words + 1)
                p.unlink()
                words = [arr[:, i] for i in range(n_words)]
                pos = arr[:, n_words].view(np.int32)
                order = np.lexsort((pos, *reversed(words)))
                words = [w[order] for w in words]
                pos = pos[order]
                n = pos.shape[0]
                total += n
                new_group = np.empty(n, dtype=bool)
                new_group[0] = True
                diff = words[0][1:] != words[0][:-1]
                for w in words[1:]:
                    diff = diff | (w[1:] != w[:-1])
                new_group[1:] = diff
                group_id = np.cumsum(new_group) - 1
                counts = np.bincount(group_id)
                too_many = counts > repeat_threshold
                keep = ~too_many[group_id]
                sentinel = new_group & too_many[group_id]
                out_mask = keep | sentinel
                out_pos = np.where(sentinel[out_mask], TOO_MANY_POS,
                                   pos[out_mask]).astype(np.int32)
                for name, w in zip(plane_names, words):
                    files[name].write(bias_u32_to_i32(w[out_mask]).tobytes())
                files["pos"].write(out_pos.tobytes())
                collapsed += int(too_many.sum())
        finally:
            for f in files.values():
                f.close()

        for name, rp in raw.items():
            _raw_to_npy(rp, out / f"{name}.npy", np.int32)
    np.save(out / "genome.npy", codes)
    meta = {
        "format_version": 1,
        "seed_len": seed_len,
        "repeat_threshold": repeat_threshold,
        "total_kmers": total,
        "collapsed_kmers": collapsed,
        "contigs": [
            {"index": c.index, "name": c.name, "offset": c.offset,
             "length": c.length, "md5": c.md5}
            for c in genome.contigs
        ],
    }
    (out / "sorted-reference.json").write_text(json.dumps(meta, indent=2))

    index = SeedIndex.load(out, mmap=True)
    if annotate_neighbors:
        from ..utils import tracing
        from .neighbors import annotate_index_chunked
        tracing.log("streaming build: neighbor annotation runs per prefix "
                    "partition (bounded RAM); pass --dont-annotate to skip")
        bits = annotate_index_chunked(
            index.key_hi, index.key_lo, k=seed_len,
            out_path=out / "neighbors.npy", work_dir=work_dir, device=device)
        if isinstance(bits, np.memmap):
            bits.flush()        # already written straight to neighbors.npy
        else:
            np.save(out / "neighbors.npy", bits)
        index.has_neighbors = bits
    return index
