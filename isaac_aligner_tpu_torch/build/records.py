"""Columnar packed fragment records + vectorized BAM serialization.

The port's own copy of `isaac_aligner_tpu/build/records.py`, unchanged;
the native helpers are the port's builds of `native/{bamrec,scatter}.cpp`.

The columnar replacement for the reference's packed fragment format
(src/c++/include/io/Fragment.hh FragmentHeader/FragmentAccessor) and its
BAM serializer (include/build/BamSerializer.hh:39-88,
include/bam/Bam.hh:154 serializeAlignment): instead of one packed struct
per fragment walked by per-record C++ (or, worse, per-record Python),
every field lives in a flat numpy column so binning, sorting, duplicate
marking and BAM byte assembly are single vectorized passes.

A `FragmentBatch` holds one batch/bin of records.  Bins on disk are .npz
files of these columns (the analog of the reference's bin files written
by matchSelector/BinningFragmentStorage.cpp), and `to_bam_bytes` turns a
coordinate-sorted batch straight into the uncompressed BAM byte stream —
no per-read Python anywhere on the output path.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from ..io import sam

# BAM cigar op encoding (SAM spec §4.2)
CIGAR_OPS = "MIDNSHP=X"
_OP_CODE = {op: i for i, op in enumerate(CIGAR_OPS)}
# ops that consume reference
_REF_CONSUME = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1], dtype=np.uint32)
# ops that consume read bases
_READ_CONSUME = np.array([1, 1, 0, 0, 1, 0, 0, 1, 1], dtype=np.uint32)

# BAM 4-bit seq nibbles for codes A,C,G,T,N
_BAM_NIB = np.array([1, 2, 4, 8, 15], dtype=np.uint8)

_ABSENT = -1  # sentinel for absent int tags / unmapped refs


@dataclasses.dataclass
class FragmentBatch:
    """One batch of alignment records, columnar.

    All arrays share leading dim N.  Sequences/quals are stored in OUTPUT
    orientation (already reverse-complemented for reverse alignments).
    `pos`/`mate_pos` are 0-based; -1 plus ref_id -1 mean "*".
    """

    name_bytes: np.ndarray   # uint8 [N, NW] zero-padded read names
    name_len: np.ndarray     # int32 [N]
    flag: np.ndarray         # uint16 [N]
    ref_id: np.ndarray       # int32 [N]
    pos: np.ndarray          # int32 [N]
    mapq: np.ndarray         # uint8 [N]
    cigar_ops: np.ndarray    # uint32 [N, C] BAM packed len<<4|op
    n_cigar: np.ndarray      # int16 [N]
    seq: np.ndarray          # uint8 [N, L] codes 0..4, output orientation
    qual: np.ndarray         # uint8 [N, L] phred, output orientation
    length: np.ndarray       # int32 [N] true read length
    mate_ref_id: np.ndarray  # int32 [N]
    mate_pos: np.ndarray     # int32 [N]
    tlen: np.ndarray         # int32 [N]
    # int tags, -1 = absent
    nm: np.ndarray           # int32 [N]
    sm: np.ndarray           # int32 [N]
    as_: np.ndarray          # int32 [N]
    mq: np.ndarray           # int32 [N]
    zx: np.ndarray           # int32 [N] cluster X coordinate
    zy: np.ndarray           # int32 [N] cluster Y coordinate
    rg: np.ndarray           # int32 [N] index into rg_names, -1 absent
    # mate cigar (MC tag); n_mc == 0 -> absent
    mc_ops: np.ndarray       # uint32 [N, C]
    n_mc: np.ndarray         # int16 [N]
    # duplicate-index columns, precomputed at conversion time (reference
    # stores them in the packed fragment record: FragmentIndex.hh:36-186
    # anchors + io/Fragment.hh:398 duplicateClusterRank) so per-bin dedup
    # never needs the mate record:
    #   anchor_self/mate: (unclipped-5' global pos << 1 | strand), or the
    #   bases-hash pseudo anchor (bit 62 set) for unmapped ends; -1 = none
    anchor_self: np.ndarray = None   # int64 [N]
    anchor_mate: np.ndarray = None   # int64 [N]
    dup_rank: np.ndarray = None      # int64 [N] template-level rank
    dup_tie: np.ndarray = None       # int64 [N] deterministic tiebreak
    # rare/ragged extras
    bc: np.ndarray | None = None   # uint8 [N, BW] barcode ascii, 0-padded
    oc: np.ndarray | None = None   # object [N] original-cigar strings
    rg_names: tuple[str, ...] = ()

    def __len__(self) -> int:
        return int(self.flag.shape[0])

    @property
    def count(self) -> int:
        return len(self)

    # -- construction helpers -------------------------------------------------

    @staticmethod
    def empty(n: int, read_len: int, name_w: int = 8, max_cigar: int = 16,
              rg_names: tuple[str, ...] = ()) -> "FragmentBatch":
        z = lambda dt, *shape: np.zeros(shape or (n,), dt)
        return FragmentBatch(
            name_bytes=z(np.uint8, n, name_w), name_len=z(np.int32),
            flag=z(np.uint16), ref_id=np.full(n, -1, np.int32),
            pos=np.full(n, -1, np.int32), mapq=z(np.uint8),
            cigar_ops=z(np.uint32, n, max_cigar), n_cigar=z(np.int16),
            seq=np.full((n, read_len), 4, np.uint8), qual=z(np.uint8, n, read_len),
            length=z(np.int32), mate_ref_id=np.full(n, -1, np.int32),
            mate_pos=np.full(n, -1, np.int32), tlen=z(np.int32),
            nm=np.full(n, _ABSENT, np.int32), sm=np.full(n, _ABSENT, np.int32),
            as_=np.full(n, _ABSENT, np.int32), mq=np.full(n, _ABSENT, np.int32),
            zx=np.full(n, _ABSENT, np.int32), zy=np.full(n, _ABSENT, np.int32),
            rg=np.full(n, _ABSENT, np.int32),
            mc_ops=z(np.uint32, n, max_cigar), n_mc=z(np.int16),
            anchor_self=np.full(n, -1, np.int64),
            anchor_mate=np.full(n, -1, np.int64),
            dup_rank=z(np.int64), dup_tie=z(np.int64),
            rg_names=tuple(rg_names))

    def take(self, idx: np.ndarray) -> "FragmentBatch":
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            kw[f.name] = v[idx] if isinstance(v, np.ndarray) else v
        return FragmentBatch(**kw)

    def names(self) -> list[str]:
        return [self.name_bytes[i, : self.name_len[i]].tobytes().decode("ascii")
                for i in range(len(self))]

    def template_ids(self) -> np.ndarray:
        """Dense template ids: equal read names -> equal id.  Ids follow
        lexicographic name order (stable cross-batch tie-break)."""
        view = np.ascontiguousarray(self.name_bytes).view(
            np.dtype((np.void, self.name_bytes.shape[1])))[:, 0]
        _, inv = np.unique(view, return_inverse=True)
        return inv.astype(np.int64)

    # -- persistence ----------------------------------------------------------

    def save(self, path: str | Path) -> None:
        """Write the batch as a flat columnar chunk: a length-prefixed
        JSON field list, then one raw .npy stream per column (no zip
        container / CRC work — the reference's packed fragment temp files
        are raw structs for the same reason, io/Fragment.hh)."""
        import json
        import struct
        arrs = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), np.ndarray)}
        if self.oc is not None:
            arrs["oc"] = np.array([x or "" for x in self.oc], dtype="S")
        arrs["rg_names"] = np.array(list(self.rg_names), dtype="S")
        header = json.dumps(list(arrs)).encode("ascii")
        with open(path, "wb") as f:
            f.write(struct.pack("<I", len(header)))
            f.write(header)
            for v in arrs.values():
                np.lib.format.write_array(f, np.ascontiguousarray(v),
                                          allow_pickle=False)

    @staticmethod
    def load(path: str | Path) -> "FragmentBatch":
        import json
        import struct
        with open(path, "rb") as f:
            magic = f.read(4)
            if magic == b"PK\x03\x04":   # legacy .npz chunks (resume compat)
                with np.load(path, allow_pickle=False) as z:
                    arrs = {k: z[k] for k in z.files}
            else:
                (hlen,) = struct.unpack("<I", magic)
                fields = json.loads(f.read(hlen).decode("ascii"))
                arrs = {k: np.lib.format.read_array(f, allow_pickle=False)
                        for k in fields}
        kw = {k: v for k, v in arrs.items() if k not in ("rg_names", "oc")}
        rg = tuple(s.decode("ascii") for s in arrs["rg_names"]) \
            if "rg_names" in arrs else ()
        oc = None
        if "oc" in arrs:
            raw = [s.decode("ascii") for s in arrs["oc"]]
            if any(raw):
                oc = np.array([s or None for s in raw], dtype=object)
        return FragmentBatch(**kw, rg_names=rg, oc=oc)


def concat(batches: list[FragmentBatch]) -> FragmentBatch:
    """Concatenate batches, padding name/cigar/read widths to the max."""
    if len(batches) == 1:
        return batches[0]
    nw = max(b.name_bytes.shape[1] for b in batches)
    cw = max(max(b.cigar_ops.shape[1], b.mc_ops.shape[1]) for b in batches)
    lw = max(b.seq.shape[1] for b in batches)
    bw = max((b.bc.shape[1] for b in batches if b.bc is not None), default=0)
    rg_names: list[str] = []
    for b in batches:
        for nm_ in b.rg_names:
            if nm_ not in rg_names:
                rg_names.append(nm_)

    def pad2(a, w, fill=0):
        if a.shape[1] == w:
            return a
        out = np.full((a.shape[0], w), fill, a.dtype)
        out[:, : a.shape[1]] = a
        return out

    cols: dict[str, np.ndarray] = {}
    for f in dataclasses.fields(FragmentBatch):
        nm_ = f.name
        if nm_ in ("rg_names",):
            continue
        parts = []
        for b in batches:
            v = getattr(b, nm_)
            if nm_ == "name_bytes":
                v = pad2(v, nw)
            elif nm_ in ("cigar_ops", "mc_ops"):
                v = pad2(v, cw)
            elif nm_ == "seq":
                v = pad2(v, lw, fill=4)
            elif nm_ == "qual":
                v = pad2(v, lw)
            elif nm_ == "bc":
                if bw == 0:
                    v = None
                else:
                    v = pad2(v if v is not None
                             else np.zeros((len(b), 0), np.uint8), bw)
            elif nm_ == "oc":
                if v is None and any(x.oc is not None for x in batches):
                    v = np.full(len(b), None, dtype=object)
            elif nm_ == "rg":
                remap = np.array(
                    [rg_names.index(r) for r in b.rg_names] or [0], np.int32)
                v = np.where(v >= 0, remap[np.maximum(v, 0)], v)
            parts.append(v)
        if any(p is None for p in parts):
            cols[nm_] = None
        else:
            cols[nm_] = np.concatenate(parts)
    return FragmentBatch(**cols, rg_names=tuple(rg_names))


def _scan_chunk(path):
    """(field -> (shape, dtype), rg_names) from a chunk's headers only —
    array payloads are seeked over, not read.  None for legacy .npz."""
    import json
    import struct
    with open(path, "rb") as f:
        magic = f.read(4)
        if magic == b"PK\x03\x04":      # legacy .npz chunk (resume compat)
            return None
        (hlen,) = struct.unpack("<I", magic)
        names = json.loads(f.read(hlen).decode("ascii"))
        info: dict = {}
        rg: tuple = ()
        for nm_ in names:
            ver = np.lib.format.read_magic(f)
            if ver == (1, 0):
                shape, _fort, dtype = np.lib.format.read_array_header_1_0(f)
            else:
                shape, _fort, dtype = np.lib.format.read_array_header_2_0(f)
            count = int(np.prod(shape)) if shape else 1
            if nm_ == "rg_names":
                data = np.fromfile(f, dtype=dtype, count=count)
                rg = tuple(s.decode("ascii") for s in data)
            else:
                f.seek(count * dtype.itemsize, 1)
                info[nm_] = (shape, dtype)
        return info, rg


def concat_chunk_files(paths) -> FragmentBatch:
    """Load + concatenate saved chunk files with ~one-chunk transient RAM.

    `load_bin` previously materialized every chunk, then concatenated —
    a transient 2x-bin-RAM spike inside the Build loader thread.  Here a
    header-only scan sizes the output columns first, then each chunk is
    loaded once and written straight into its row slice of the
    preallocated output.  Reference analog: Build's memory-aware bin
    admission (include/build/Build.hh:163-183) — the bin budget is the
    bound, not 2x the bin.
    """
    paths = list(paths)
    if len(paths) == 1:
        return FragmentBatch.load(paths[0])
    scans = [_scan_chunk(p) for p in paths]
    if any(s is None for s in scans):   # legacy chunks present: old path
        return concat([FragmentBatch.load(p) for p in paths])
    infos = [s[0] for s in scans]
    rgs = [s[1] for s in scans]
    rows = [int(info["flag"][0][0]) for info in infos]
    total = sum(rows)
    nw = max(info["name_bytes"][0][1] for info in infos)
    cw = max(max(info["cigar_ops"][0][1], info["mc_ops"][0][1])
             for info in infos)
    lw = max(info["seq"][0][1] for info in infos)
    bw = max((info["bc"][0][1] for info in infos if "bc" in info), default=0)
    any_oc = any("oc" in info for info in infos)
    rg_names: list[str] = []
    for rg in rgs:
        for nm_ in rg:
            if nm_ not in rg_names:
                rg_names.append(nm_)

    widths = {"name_bytes": (nw, 0), "cigar_ops": (cw, 0), "mc_ops": (cw, 0),
              "seq": (lw, 4), "qual": (lw, 0)}
    cols: dict = {}
    for f in dataclasses.fields(FragmentBatch):
        nm_ = f.name
        if nm_ == "rg_names":
            continue
        if nm_ == "oc":
            cols[nm_] = np.full(total, None, object) if any_oc else None
            continue
        if nm_ == "bc":
            cols[nm_] = np.zeros((total, bw), np.uint8) if bw else None
            continue
        if not all(nm_ in info for info in infos):
            cols[nm_] = None            # matches concat(): any-None -> None
            continue
        shape, dtype = infos[0][nm_]
        if nm_ in widths:
            w, fill = widths[nm_]
            cols[nm_] = np.full((total, w), fill, dtype)
        else:
            cols[nm_] = np.empty((total,) + tuple(shape[1:]), dtype)

    r0 = 0
    for p in paths:
        b = FragmentBatch.load(p)
        r1 = r0 + len(b)
        for f in dataclasses.fields(FragmentBatch):
            nm_ = f.name
            if nm_ == "rg_names" or cols.get(nm_) is None:
                continue
            out = cols[nm_]
            v = getattr(b, nm_)
            if nm_ == "rg":
                remap = np.array([rg_names.index(r) for r in b.rg_names]
                                 or [0], np.int32)
                out[r0:r1] = np.where(v >= 0, remap[np.maximum(v, 0)], v)
            elif nm_ == "oc":
                if v is not None:
                    out[r0:r1] = v
            elif nm_ == "bc":
                if v is not None and v.shape[1]:
                    out[r0:r1, : v.shape[1]] = v
            elif out.ndim == 2:
                out[r0:r1, : v.shape[1]] = v
            else:
                out[r0:r1] = v
        r0 = r1
    return FragmentBatch(**cols, rg_names=tuple(rg_names))


# ---------------------------------------------------------------------------
# CIGAR codecs (string <-> packed ops), vectorized over unique values
# ---------------------------------------------------------------------------

def parse_cigar_ops(s: str) -> list[int]:
    out = []
    num = ""
    for ch in s:
        if ch.isdigit():
            num += ch
        else:
            out.append((int(num) << 4) | _OP_CODE[ch])
            num = ""
    return out


def cigars_to_ops(cigars, lengths: np.ndarray,
                  default_m: np.ndarray | None = None
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Convert a per-row cigar string list (None => '{len}M') to packed
    ops.  Parses each DISTINCT string once (batches contain few distinct
    cigars), scattering to rows — no per-row Python for the common case.
    """
    n = len(lengths)
    if cigars is None:
        cigars = [None] * n
    arr = np.array([c if c else "" for c in cigars], dtype=object)
    uniq, inv = np.unique(arr.astype("U"), return_inverse=True)
    parsed = [parse_cigar_ops(u) if u else [] for u in uniq]
    max_ops = max(4, max((len(p) for p in parsed), default=1))
    table = np.zeros((len(uniq), max_ops), np.uint32)
    counts = np.zeros(len(uniq), np.int16)
    for i, p in enumerate(parsed):
        table[i, : len(p)] = p
        counts[i] = len(p)
    ops = table[inv]
    n_ops = counts[inv]
    # rows without a cigar: single '{len}M' (or default_m lengths)
    none_rows = n_ops == 0
    if none_rows.any():
        m_len = (default_m if default_m is not None else lengths).astype(np.int64)
        ops[none_rows, 0] = (m_len[none_rows].astype(np.uint32) << 4) | 0
        n_ops = np.where(none_rows & (m_len > 0), 1, n_ops).astype(np.int16)
    return ops, n_ops


def ops_to_strings(ops: np.ndarray, n_ops: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Packed ops -> (ascii byte matrix [N, W], strlen [N], strings [U]).

    Builds strings only for DISTINCT op rows.
    """
    n, c = ops.shape
    if n == 0:
        return (np.zeros((0, 1), np.uint8), np.zeros(0, np.int32),
                np.zeros(0, dtype=object))
    key = np.concatenate([ops, n_ops[:, None].astype(np.uint32)], axis=1)
    view = np.ascontiguousarray(key).view(
        np.dtype((np.void, key.shape[1] * 4)))[:, 0]
    uniq, first_idx, inv = np.unique(view, return_index=True,
                                     return_inverse=True)
    strs = []
    for fi in first_idx:
        k = int(n_ops[fi])
        strs.append("".join(f"{int(ops[fi, j]) >> 4}{CIGAR_OPS[int(ops[fi, j]) & 0xF]}"
                            for j in range(k)))
    w = max(1, max((len(s) for s in strs), default=1))
    mat = np.zeros((len(strs), w), np.uint8)
    lens = np.zeros(len(strs), np.int32)
    for i, s in enumerate(strs):
        b = s.encode("ascii")
        mat[i, : len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    return mat[inv], lens[inv], np.array(strs, dtype=object)[inv]


def ref_span(ops: np.ndarray, n_ops: np.ndarray) -> np.ndarray:
    """Reference bases consumed by each cigar (vectorized)."""
    c = ops.shape[1]
    valid = np.arange(c)[None, :] < n_ops[:, None]
    lens = (ops >> 4).astype(np.int64)
    consume = _REF_CONSUME[ops & 0xF].astype(np.int64)
    return (lens * consume * valid).sum(axis=1).astype(np.int32)


def clip_spans(ops: np.ndarray, n_ops: np.ndarray
               ) -> tuple[np.ndarray, np.ndarray]:
    """(leading softclip, trailing softclip) per row, vectorized."""
    n, c = ops.shape
    op = (ops & 0xF).astype(np.int32)
    ln = (ops >> 4).astype(np.int32)
    lead = np.where((n_ops > 0) & (op[:, 0] == _OP_CODE["S"]), ln[:, 0], 0)
    last = np.maximum(n_ops.astype(np.int64) - 1, 0)
    rows = np.arange(n)
    tail = np.where((n_ops > 1) & (op[rows, last] == _OP_CODE["S"]),
                    ln[rows, last], 0)
    return lead.astype(np.int32), tail.astype(np.int32)


# ---------------------------------------------------------------------------
# Vectorized BAM byte assembly
# ---------------------------------------------------------------------------

_HDR_DT = np.dtype([
    ("bs", "<i4"), ("ref", "<i4"), ("pos", "<i4"), ("lrn", "u1"),
    ("mapq", "u1"), ("bin", "<u2"), ("ncig", "<u2"), ("flag", "<u2"),
    ("lseq", "<i4"), ("nref", "<i4"), ("npos", "<i4"), ("tlen", "<i4")])
assert _HDR_DT.itemsize == 36


def reg2bin_vec(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """Vectorized SAM-spec distributed binning (io/bam.py reg2bin)."""
    e = end - 1
    out = np.zeros(beg.shape, np.int64)
    done = np.zeros(beg.shape, bool)
    for shift, base in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        hit = ~done & ((beg >> shift) == (e >> shift))
        out = np.where(hit, base + (beg >> shift), out)
        done |= hit
    return out


_SCATTER_LIB: object = None
_SCATTER_TRIED = False


def _scatter_lib():
    """Compile-on-first-use native row-memcpy scatter (native/scatter.cpp);
    None when the toolchain is unavailable (numpy fallback below)."""
    global _SCATTER_LIB, _SCATTER_TRIED
    if not _SCATTER_TRIED:
        import ctypes

        from ..native.build import load_library
        _SCATTER_LIB = load_library("scatter")
        if _SCATTER_LIB is not None:
            p, i64 = ctypes.c_void_p, ctypes.c_int64
            _SCATTER_LIB.ragged_scatter.argtypes = [p, p, p, i64, p, i64]
            _SCATTER_LIB.ragged_scatter.restype = None
            _SCATTER_LIB.fixed_scatter.argtypes = [p, p, p, i64, i64]
            _SCATTER_LIB.fixed_scatter.restype = None
        _SCATTER_TRIED = True
    return _SCATTER_LIB


_BAMREC_LIB = None
_BAMREC_TRIED = False


def _bamrec_lib():
    """Compile-on-first-use fused record-core assembler
    (native/bamrec.cpp); None when the toolchain is unavailable."""
    global _BAMREC_LIB, _BAMREC_TRIED
    if not _BAMREC_TRIED:
        import ctypes

        from ..native.build import load_library
        _BAMREC_LIB = load_library("bamrec")
        if _BAMREC_LIB is not None:
            p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
            _BAMREC_LIB.assemble_bam_core.argtypes = (
                [p] * 14 + [i64, p, p, i64, p, p, i64, i64, i32])
            _BAMREC_LIB.assemble_bam_core.restype = None
        _BAMREC_TRIED = True
    return _BAMREC_LIB


def _ragged_scatter(out: np.ndarray, dest: np.ndarray, src: np.ndarray,
                    src_len: np.ndarray) -> None:
    """out[dest[i] : dest[i]+src_len[i]] = src[i, :src_len[i]] for all i."""
    src_len = src_len.astype(np.int64)
    n = len(src_len)
    if n == 0:
        return
    lib = _scatter_lib()
    if lib is not None:
        src_c = np.ascontiguousarray(src, np.uint8)
        dest_c = np.ascontiguousarray(dest, np.int64)
        lib.ragged_scatter(out.ctypes.data, dest_c.ctypes.data,
                           src_c.ctypes.data, src_c.shape[1],
                           np.ascontiguousarray(src_len).ctypes.data, n)
        return
    w0 = int(src_len[0])
    if w0 and (src_len == w0).all():
        # uniform width (sequences/quals of equal-length reads, most
        # cigars): one rectangular scatter, no per-byte index vectors
        out[dest.astype(np.int64)[:, None] + np.arange(w0)] = src[:, :w0]
        return
    total = int(src_len.sum())
    if total == 0:
        return
    rows = np.repeat(np.arange(n), src_len)
    starts = np.cumsum(src_len) - src_len
    within = np.arange(total) - np.repeat(starts, src_len)
    vals = np.take(src.reshape(-1), rows * src.shape[1] + within)
    out[np.repeat(dest.astype(np.int64), src_len) + within] = vals


def _fixed_scatter(out: np.ndarray, dest: np.ndarray, src: np.ndarray
                   ) -> None:
    """out[dest[i] : dest[i]+w] = src[i] for a uniform-width [n, w] src."""
    n, w = src.shape
    if n == 0:
        return
    lib = _scatter_lib()
    if lib is not None:
        src_c = np.ascontiguousarray(src, np.uint8)
        dest_c = np.ascontiguousarray(dest, np.int64)
        lib.fixed_scatter(out.ctypes.data, dest_c.ctypes.data,
                          src_c.ctypes.data, w, n)
        return
    out[dest.astype(np.int64)[:, None] + np.arange(w)] = src


def _int_tag_bytes(tag: bytes, values: np.ndarray) -> np.ndarray:
    """[N, 7] byte matrix for an int ('i') tag."""
    n = len(values)
    out = np.empty((n, 7), np.uint8)
    out[:, 0] = tag[0]
    out[:, 1] = tag[1]
    out[:, 2] = ord("i")
    out[:, 3:] = values.astype("<i4").view(np.uint8).reshape(n, 4)
    return out


def to_bam_bytes(fb: FragmentBatch) -> tuple[bytes, np.ndarray, np.ndarray,
                                             np.ndarray]:
    """Serialize the batch to BAM record bytes — one vectorized pass.

    Returns (bytes, u_start, u_end, ref_end) where u_start/u_end are each
    record's offsets inside the returned buffer (for .bai virtual-offset
    accounting) and ref_end is pos + max(1, ref span) (for binning).

    Tag order matches the reference writer (sorted tag names):
    AS, BC, MC, MQ, NM, OC, RG, SM, ZX, ZY.
    """
    n = len(fb)
    if n == 0:
        e = np.zeros(0, np.int64)
        return b"", e, e, e
    lengths = fb.length.astype(np.int64)
    name_l = fb.name_len.astype(np.int64) + 1           # + NUL
    n_cig = np.where(fb.ref_id >= 0, fb.n_cigar, 0).astype(np.int64)
    seq_b = (lengths + 1) // 2

    # ---- tag presence + sizes
    has_as = fb.as_ != _ABSENT
    has_mq = fb.mq != _ABSENT
    has_nm = fb.nm != _ABSENT
    has_sm = fb.sm != _ABSENT
    has_zx = fb.zx != _ABSENT
    has_zy = fb.zy != _ABSENT
    has_mc = fb.n_mc > 0
    mc_mat, mc_len, _ = ops_to_strings(fb.mc_ops, np.where(has_mc, fb.n_mc, 0))
    mc_len = np.where(has_mc, mc_len, 0).astype(np.int64)
    if fb.bc is not None:
        bc_len = (fb.bc != 0).sum(axis=1).astype(np.int64)
    else:
        bc_len = np.zeros(n, np.int64)
    has_bc = bc_len > 0
    if fb.oc is not None:
        oc_len = np.array([len(x) if x else 0 for x in fb.oc], np.int64)
    else:
        oc_len = np.zeros(n, np.int64)
    has_oc = oc_len > 0
    if fb.rg_names:
        rg_tab = np.array([r.encode("ascii") for r in fb.rg_names], dtype="S")
        rg_w = rg_tab.dtype.itemsize
        rg_mat_tab = rg_tab.view(np.uint8).reshape(len(fb.rg_names), rg_w)
        rg_len_tab = np.array([len(r) for r in fb.rg_names], np.int64)
    has_rg = (fb.rg != _ABSENT) & bool(fb.rg_names)
    rg_len = np.where(has_rg, rg_len_tab[np.maximum(fb.rg, 0)], 0) \
        if fb.rg_names else np.zeros(n, np.int64)

    tag_sz = (7 * (has_as.astype(np.int64) + has_mq + has_nm + has_sm
                   + has_zx + has_zy)
              + np.where(has_mc, 4 + mc_len, 0)
              + np.where(has_bc, 4 + bc_len, 0)
              + np.where(has_oc, 4 + oc_len, 0)
              + np.where(has_rg, 4 + rg_len, 0))

    body = 32 + name_l + 4 * n_cig + seq_b + lengths + tag_sz
    rec = 4 + body
    u_start = np.concatenate([[0], np.cumsum(rec)[:-1]])
    total = int(rec.sum())
    out = np.zeros(total, np.uint8)

    # ---- fixed header + name + cigar + packed seq + qual: one fused
    # native pass when the toolchain is present (native/bamrec.cpp —
    # the numpy version below made ~10 full [N, L] passes and sat on the
    # 2-core e2e critical path), numpy fallback otherwise
    pos0 = np.where(fb.ref_id >= 0, fb.pos, -1).astype(np.int64)
    span = ref_span(fb.cigar_ops, fb.n_cigar.astype(np.int64)).astype(np.int64)
    ref_end = pos0 + np.maximum(1, span)
    bins = np.where((fb.ref_id >= 0) & (pos0 >= 0),
                    reg2bin_vec(np.maximum(pos0, 0), ref_end), 4680)
    lib = _bamrec_lib()
    if lib is not None:
        import ctypes

        def c(a):
            return np.ascontiguousarray(a).ctypes.data_as(ctypes.c_void_p)

        cig_u4 = np.ascontiguousarray(fb.cigar_ops.astype("<u4"))
        name_b = np.ascontiguousarray(fb.name_bytes)
        seq_c = np.ascontiguousarray(fb.seq)
        qual_c = np.ascontiguousarray(fb.qual)
        holds = (u_start, body.astype(np.int32), fb.ref_id.astype(np.int32),
                 pos0.astype(np.int32), fb.mapq.astype(np.uint8),
                 bins.astype(np.uint16), n_cig.astype(np.uint16),
                 fb.flag.astype(np.uint16), lengths.astype(np.int32),
                 fb.mate_ref_id.astype(np.int32),
                 np.where(fb.mate_ref_id >= 0, fb.mate_pos, -1).astype(np.int32),
                 fb.tlen.astype(np.int32), name_b,
                 fb.name_len.astype(np.int32), cig_u4, seq_c, qual_c)
        lib.assemble_bam_core(
            out.ctypes.data_as(ctypes.c_void_p), c(holds[0]), c(holds[1]),
            c(holds[2]), c(holds[3]), c(holds[4]), c(holds[5]), c(holds[6]),
            c(holds[7]), c(holds[8]), c(holds[9]), c(holds[10]), c(holds[11]),
            c(holds[12]), ctypes.c_int64(name_b.shape[1]), c(holds[13]),
            c(holds[14]), ctypes.c_int64(cig_u4.shape[1]), c(holds[15]),
            c(holds[16]), ctypes.c_int64(fb.seq.shape[1]), ctypes.c_int64(n),
            ctypes.c_int32(2))
        off = u_start + 36 + name_l + 4 * n_cig + seq_b + lengths
    else:
        hdr = np.zeros(n, _HDR_DT)
        hdr["bs"] = body
        hdr["ref"] = fb.ref_id
        hdr["pos"] = pos0
        hdr["lrn"] = name_l
        hdr["mapq"] = fb.mapq
        hdr["bin"] = bins.astype(np.uint16)
        hdr["ncig"] = n_cig
        hdr["flag"] = fb.flag
        hdr["lseq"] = lengths
        hdr["nref"] = fb.mate_ref_id
        hdr["npos"] = np.where(fb.mate_ref_id >= 0, fb.mate_pos, -1)
        hdr["tlen"] = fb.tlen
        _fixed_scatter(out, u_start, hdr.view(np.uint8).reshape(n, 36))

        # ---- name (+ NUL terminator already zero-filled)
        off = u_start + 36
        _ragged_scatter(out, off, fb.name_bytes, fb.name_len.astype(np.int64))
        off = off + name_l

        # ---- cigar
        cig8 = np.ascontiguousarray(fb.cigar_ops.astype("<u4")).view(np.uint8)
        cig8 = cig8.reshape(n, fb.cigar_ops.shape[1] * 4)
        _ragged_scatter(out, off, cig8, 4 * n_cig)
        off = off + 4 * n_cig

        # ---- seq nibbles
        L = fb.seq.shape[1]
        in_read = np.arange(L)[None, :] < lengths[:, None]
        nib = np.where(in_read, _BAM_NIB[np.minimum(fb.seq, 4)], 0)
        if L % 2:
            nib = np.concatenate([nib, np.zeros((n, 1), np.uint8)], axis=1)
        packed = (nib[:, 0::2] << 4) | nib[:, 1::2]
        _ragged_scatter(out, off, packed, seq_b)
        off = off + seq_b

        # ---- qual
        _ragged_scatter(out, off, np.minimum(fb.qual, 93), lengths)
        off = off + lengths

    # ---- tags, sorted name order
    def put_int(tag: bytes, vals: np.ndarray, has: np.ndarray,
                off: np.ndarray) -> np.ndarray:
        idx = np.nonzero(has)[0]
        if idx.size:
            _fixed_scatter(out, off[idx], _int_tag_bytes(tag, vals[idx]))
        return off + 7 * has

    def put_z(tag: bytes, mat: np.ndarray, slen: np.ndarray,
              has: np.ndarray, off: np.ndarray) -> np.ndarray:
        idx = np.nonzero(has)[0]
        if idx.size:
            pre = np.tile(np.frombuffer(tag + b"Z", np.uint8), (idx.size, 1))
            _fixed_scatter(out, off[idx], pre)
            _ragged_scatter(out, off[idx] + 3, mat[idx], slen[idx])
            # NUL already zero
        return off + np.where(has, 4 + slen, 0)

    off = put_int(b"AS", fb.as_, has_as, off)
    if fb.bc is not None:
        off = put_z(b"BC", fb.bc, bc_len, has_bc, off)
    off = put_z(b"MC", mc_mat, mc_len, has_mc, off)
    off = put_int(b"MQ", fb.mq, has_mq, off)
    off = put_int(b"NM", fb.nm, has_nm, off)
    if fb.oc is not None and has_oc.any():
        w = int(oc_len.max())
        oc_mat = np.zeros((n, w), np.uint8)
        for i in np.nonzero(has_oc)[0]:
            b = fb.oc[i].encode("ascii")
            oc_mat[i, : len(b)] = np.frombuffer(b, np.uint8)
        off = put_z(b"OC", oc_mat, oc_len, has_oc, off)
    if fb.rg_names:
        rg_mat = rg_mat_tab[np.maximum(fb.rg, 0)]
        off = put_z(b"RG", rg_mat, rg_len, has_rg, off)
    off = put_int(b"SM", fb.sm, has_sm, off)
    off = put_int(b"ZX", fb.zx, has_zx, off)
    off = put_int(b"ZY", fb.zy, has_zy, off)

    return out.tobytes(), u_start, u_start + rec, ref_end


def apply_tag_exclusions(fb: FragmentBatch, tags) -> FragmentBatch:
    """Blank excluded optional tags (reference --bam-exclude-tags,
    manual.md:274).  Mutates and returns fb."""
    for tag, col in (("AS", fb.as_), ("NM", fb.nm), ("SM", fb.sm),
                     ("MQ", fb.mq), ("ZX", fb.zx), ("ZY", fb.zy)):
        if tag in tags:
            col[:] = _ABSENT
    if "BC" in tags:
        fb.bc = None
    if "OC" in tags:
        fb.oc = None
    if "RG" in tags:
        fb.rg_names = ()
        fb.rg[:] = _ABSENT
    return fb


# ---------------------------------------------------------------------------
# SamRecord bridge (tests, SAM text output, realignment write-back)
# ---------------------------------------------------------------------------

def to_sam_records(fb: FragmentBatch, contigs) -> list[sam.SamRecord]:
    """Expand to SamRecord objects (slow path: SAM text + unit tests)."""
    from .. import dna
    names = fb.names()
    _, _, cig_strs = ops_to_strings(fb.cigar_ops, fb.n_cigar)
    _, _, mc_strs = ops_to_strings(fb.mc_ops, fb.n_mc)
    cnames = [c.name for c in contigs]
    recs = []
    for i in range(len(fb)):
        l = int(fb.length[i])
        mapped = fb.ref_id[i] >= 0
        rname = cnames[fb.ref_id[i]] if fb.ref_id[i] >= 0 else "*"
        if fb.mate_ref_id[i] >= 0:
            mrn = cnames[fb.mate_ref_id[i]]
            rnext = "=" if mrn == rname else mrn
            pnext = int(fb.mate_pos[i]) + 1
        else:
            rnext, pnext = "*", 0
        rec = sam.SamRecord(
            qname=names[i], flag=int(fb.flag[i]), rname=rname,
            pos=int(fb.pos[i]) + 1 if fb.pos[i] >= 0 else 0,
            mapq=int(fb.mapq[i]),
            cigar=(cig_strs[i] if mapped and fb.n_cigar[i] else "*"),
            rnext=rnext, pnext=pnext, tlen=int(fb.tlen[i]),
            seq=dna.decode(fb.seq[i, :l]) if l else "*",
            qual="".join(chr(int(q) + 33) for q in fb.qual[i, :l]) if l else "*")
        for tag, val in (("AS", fb.as_[i]), ("MQ", fb.mq[i]), ("NM", fb.nm[i]),
                         ("SM", fb.sm[i]), ("ZX", fb.zx[i]), ("ZY", fb.zy[i])):
            if val != _ABSENT:
                rec.set_tag(tag, "i", int(val))
        if fb.n_mc[i] > 0:
            rec.set_tag("MC", "Z", mc_strs[i])
        if fb.rg[i] != _ABSENT and fb.rg_names:
            rec.set_tag("RG", "Z", fb.rg_names[fb.rg[i]])
        if fb.bc is not None:
            b = fb.bc[i]
            b = b[b != 0].tobytes().decode("ascii")
            if b:
                rec.set_tag("BC", "Z", b)
        if fb.oc is not None and fb.oc[i]:
            rec.set_tag("OC", "Z", fb.oc[i])
        recs.append(rec)
    return recs


def update_from_sam_records(fb: FragmentBatch, rows: np.ndarray,
                            recs: list[sam.SamRecord], contigs) -> None:
    """Write mutated SamRecords (e.g. gap-realigned) back into columns."""
    cid = {c.name: c.index for c in contigs}
    cigars = [r.cigar if r.cigar != "*" else None for r in recs]
    lens = fb.length[rows]
    ops, n_ops = cigars_to_ops(cigars, lens)
    c_have = fb.cigar_ops.shape[1]
    if ops.shape[1] > c_have:
        grow = np.zeros((len(fb), ops.shape[1]), np.uint32)
        grow[:, :c_have] = fb.cigar_ops
        fb.cigar_ops = grow
        grow_mc = np.zeros((len(fb), ops.shape[1]), np.uint32)
        grow_mc[:, : fb.mc_ops.shape[1]] = fb.mc_ops
        fb.mc_ops = grow_mc
    fb.cigar_ops[rows, : ops.shape[1]] = ops
    fb.cigar_ops[rows, ops.shape[1]:] = 0
    fb.n_cigar[rows] = n_ops
    for j, (i, r) in enumerate(zip(rows, recs)):
        fb.flag[i] = r.flag
        fb.ref_id[i] = cid.get(r.rname, -1)
        fb.pos[i] = r.pos - 1 if r.rname != "*" else -1
        fb.mapq[i] = r.mapq
        fb.tlen[i] = r.tlen
        if r.rnext == "=":
            fb.mate_ref_id[i] = fb.ref_id[i]
        else:
            fb.mate_ref_id[i] = cid.get(r.rnext, -1)
        fb.mate_pos[i] = r.pnext - 1 if r.pnext else -1
        if "NM" in r.tags:
            fb.nm[i] = int(r.tags["NM"][1])
        if "OC" in r.tags:
            if fb.oc is None:
                fb.oc = np.full(len(fb), None, dtype=object)
            fb.oc[i] = str(r.tags["OC"][1])
        if "MC" in r.tags:
            mc = parse_cigar_ops(str(r.tags["MC"][1]))
            fb.mc_ops[i, : len(mc)] = mc
            fb.mc_ops[i, len(mc):] = 0
            fb.n_mc[i] = len(mc)
