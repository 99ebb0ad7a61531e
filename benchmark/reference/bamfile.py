"""A plain BAM, BAI and MD5 reader for the reference checks (numpy,
zlib, hashlib and struct only).

`Bam` decompresses every BGZF block itself, keeping each record's
virtual offset, reads the fixed fields of all records at once, and
decodes a record's name, CIGAR, sequence, qualities and NM on demand.
`bai_errors` answers region queries through the `.bai` (bins, chunks,
linear index) and holds them against a scan of the records.
"""

from __future__ import annotations

import hashlib
import struct
import zlib
from pathlib import Path

import numpy as np

_CIGAR_OPS = "MIDNSHP=X"
_SEQ_CODES = np.array([4, 0, 1, 4, 2, 4, 4, 4, 3, 4, 4, 4, 4, 4, 4, 4],
                      np.uint8)        # =ACMGRSVTWYHKDBN -> A0 C1 G2 T3, N4
_REF_CONSUMES = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1], bool)
_TAG_SIZES = {"A": 1, "c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4,
              "f": 4}
_INT_TAGS = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i",
             "I": "<I"}


def _bgzf_blocks(raw: bytes):
    """(compressed offset, uncompressed bytes) of each BGZF block."""
    off = 0
    while off < len(raw):
        if raw[off:off + 4] != b"\x1f\x8b\x08\x04":
            raise ValueError(f"no BGZF block at byte {off}")
        xlen = struct.unpack_from("<H", raw, off + 10)[0]
        bsize, x = None, off + 12
        while x < off + 12 + xlen:
            si1, si2, slen = raw[x], raw[x + 1], struct.unpack_from(
                "<H", raw, x + 2)[0]
            if si1 == 66 and si2 == 67:
                bsize = struct.unpack_from("<H", raw, x + 4)[0]
            x += 4 + slen
        if bsize is None:
            raise ValueError(f"BGZF block at {off} has no BC field")
        data = zlib.decompress(raw[off + 12 + xlen:off + bsize - 7], -15)
        yield off, data
        off += bsize + 1


class Bam:
    """One BAM file read whole."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.raw = self.path.read_bytes()
        parts, starts, coffs = [], [], []
        u = 0
        for coff, data in _bgzf_blocks(self.raw):
            parts.append(data)
            starts.append(u)
            coffs.append(coff)
            u += len(data)
        self.data = b"".join(parts)
        self._ustart = np.array(starts, np.int64)
        self._coff = np.array(coffs, np.int64)
        d = self.data
        if d[:4] != b"BAM\x01":
            raise ValueError(f"{path} is not a BAM file")
        off = 8 + struct.unpack_from("<i", d, 4)[0]
        n_ref = struct.unpack_from("<i", d, off)[0]
        off += 4
        self.refs: list[tuple[str, int]] = []
        for _ in range(n_ref):
            l_name = struct.unpack_from("<i", d, off)[0]
            self.refs.append((d[off + 4:off + 3 + l_name].decode(),
                              struct.unpack_from("<i", d, off + 4 + l_name)[0]))
            off += 8 + l_name
        rec_off, fixed = [], []
        unpack = struct.Struct("<iiiBBHHHiiii").unpack_from
        while off < len(d):
            f = unpack(d, off)
            rec_off.append(off)
            fixed.append(f)
            off += 4 + f[0]
        a = np.array(fixed, np.int64).reshape(-1, 12)
        self.offset = np.array(rec_off, np.int64)
        self.ref_id, self.pos = a[:, 1], a[:, 2]
        self.l_name, self.mapq, self.n_cigar = a[:, 3], a[:, 4], a[:, 6]
        self.flag, self.l_seq = a[:, 7], a[:, 8]
        self.next_ref_id, self.next_pos, self.tlen = a[:, 9], a[:, 10], a[:, 11]

    def __len__(self) -> int:
        return int(self.offset.shape[0])

    def names(self) -> list[str]:
        d, offs, ls = self.data, self.offset + 36, self.l_name - 1
        return [d[o:o + n].decode() for o, n in zip(offs.tolist(), ls.tolist())]

    def _cigar_words(self, i: int) -> np.ndarray:
        o = int(self.offset[i]) + 36 + int(self.l_name[i])
        return np.frombuffer(self.data, np.uint32, int(self.n_cigar[i]), o)

    def cigar(self, i: int) -> list[tuple[int, str]]:
        w = self._cigar_words(i)
        return [(int(v >> 4), _CIGAR_OPS[int(v & 0xF)]) for v in w]

    def ref_len(self, i: int) -> int:
        w = self._cigar_words(i)
        return int((w >> 4)[_REF_CONSUMES[(w & 0xF).astype(np.int64)]].sum())

    def seq_qual(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """Sequence codes and qualities as stored (forward strand)."""
        n = int(self.l_seq[i])
        o = int(self.offset[i]) + 36 + int(self.l_name[i]) + 4 * int(
            self.n_cigar[i])
        packed = np.frombuffer(self.data, np.uint8, (n + 1) // 2, o)
        nib = np.stack([packed >> 4, packed & 0xF], axis=1).reshape(-1)[:n]
        qual = np.frombuffer(self.data, np.uint8, n, o + (n + 1) // 2)
        return _SEQ_CODES[nib], qual

    def int_tag(self, i: int, tag: str) -> int | None:
        n = int(self.l_seq[i])
        o = int(self.offset[i]) + 36 + int(self.l_name[i]) + 4 * int(
            self.n_cigar[i]) + (n + 1) // 2 + n
        end = int(self.offset[i]) + 4 + struct.unpack_from(
            "<i", self.data, int(self.offset[i]))[0]
        d, key = self.data, tag.encode()
        while o < end:
            t, typ = d[o:o + 2], chr(d[o + 2])
            o += 3
            if t == key:
                if typ not in _INT_TAGS:
                    raise ValueError(f"tag {tag} has type {typ}")
                return struct.unpack_from(_INT_TAGS[typ], d, o)[0]
            if typ in _TAG_SIZES:
                o += _TAG_SIZES[typ]
            elif typ in "ZH":
                o = d.index(b"\x00", o) + 1
            elif typ == "B":
                sub, cnt = chr(d[o]), struct.unpack_from("<i", d, o + 1)[0]
                o += 5 + cnt * _TAG_SIZES[sub]
            else:
                raise ValueError(f"unknown tag type {typ!r}")
        return None

    def voffsets(self) -> np.ndarray:
        """Virtual file offset of each record (BGZF block start << 16 |
        offset inside the block)."""
        b = np.searchsorted(self._ustart, self.offset, side="right") - 1
        return ((self._coff[b] << 16) | (self.offset - self._ustart[b])
                ).astype(np.uint64)

    def order_errors(self) -> int:
        """Records out of coordinate order: (reference, position) falling,
        or a placed record after the first unplaced one."""
        placed = self.ref_id >= 0
        first_unplaced = int(np.argmin(placed)) if not placed.all() else len(self)
        bad = int(placed[first_unplaced:].sum())
        r, p = self.ref_id[:first_unplaced], self.pos[:first_unplaced]
        back = (r[1:] < r[:-1]) | ((r[1:] == r[:-1]) & (p[1:] < p[:-1]))
        return bad + int(back.sum())

    def md5_errors(self) -> int:
        """1 when the `.md5` beside the BAM is missing or differs from the
        file's digest."""
        p = Path(str(self.path) + ".md5")
        if not p.is_file():
            return 1
        want = p.read_text().split()[0] if p.read_text().split() else ""
        return int(want != hashlib.md5(self.raw).hexdigest())


def _reg2bins(beg: int, end: int) -> list[int]:
    end -= 1
    out = [0]
    for shift, base in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        out.extend(range(base + (beg >> shift), base + (end >> shift) + 1))
    return out


def read_bai(path: str | Path) -> list[dict]:
    d = Path(path).read_bytes()
    if d[:4] != b"BAI\x01":
        raise ValueError(f"{path} is not a BAI file")
    n_ref = struct.unpack_from("<i", d, 4)[0]
    off = 8
    out = []
    for _ in range(n_ref):
        n_bin = struct.unpack_from("<i", d, off)[0]
        off += 4
        bins = {}
        for _ in range(n_bin):
            b, n_chunk = struct.unpack_from("<Ii", d, off)
            off += 8
            chunks = [struct.unpack_from("<QQ", d, off + 16 * k)
                      for k in range(n_chunk)]
            off += 16 * n_chunk
            bins[b] = chunks
        n_intv = struct.unpack_from("<i", d, off)[0]
        off += 4
        ioff = list(struct.unpack_from(f"<{n_intv}Q", d, off))
        off += 8 * n_intv
        out.append({"bins": bins, "ioffsets": ioff})
    return out


def bai_errors(bam: Bam, rng: np.random.Generator, n_queries: int = 24,
               width: int = 20_000) -> int:
    """Region queries through `<bam>.bai` that find another set of
    records than a scan of the BAM: each query takes a random window of a
    random reference with records; a record overlaps it when it starts
    before its end and ends after its start (an unmapped record placed at
    its mate's position spans one base)."""
    p = Path(str(bam.path) + ".bai")
    if not p.is_file():
        return n_queries
    try:
        index = read_bai(p)
    except (ValueError, struct.error):
        return n_queries
    placed = np.nonzero(bam.ref_id >= 0)[0]
    if placed.size == 0:
        return 0
    vo = None
    errors = 0
    for _ in range(n_queries):
        r = int(bam.ref_id[placed[int(rng.integers(0, placed.size))]])
        rec = placed[bam.ref_id[placed] == r]
        ref_len = bam.refs[r][1]
        beg = int(rng.integers(0, max(1, ref_len - width)))
        end = min(ref_len, beg + width)
        # scan: records of r starting before `end` and ending after `beg`
        cand = rec[bam.pos[rec] < end]
        cand = cand[bam.pos[cand] >= beg - 2000]
        want = {int(i) for i in cand
                if bam.pos[i] + max(1, bam.ref_len(i)
                                    if not bam.flag[i] & 4 else 1) > beg}
        if r >= len(index):
            errors += 1
            continue
        if vo is None:
            vo = bam.voffsets()
        lin = index[r]["ioffsets"]
        min_off = lin[beg >> 14] if (beg >> 14) < len(lin) else 0
        got = set()
        for b in _reg2bins(beg, end):
            for c_beg, c_end in index[r]["bins"].get(b, []):
                if c_end <= min_off:
                    continue
                hit = np.nonzero((vo >= np.uint64(c_beg))
                                 & (vo < np.uint64(c_end)))[0]
                for i in hit.tolist():
                    if bam.ref_id[i] == r and bam.pos[i] < end and (
                            bam.pos[i] + max(1, bam.ref_len(i)
                                             if not bam.flag[i] & 4 else 1)
                            > beg):
                        got.add(i)
        errors += int(got != want)
    return errors
