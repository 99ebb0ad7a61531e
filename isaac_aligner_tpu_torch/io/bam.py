"""Binary BAM output: record serialization, BGZF streaming, .bai, md5.

The port's own copy of `isaac_aligner_tpu/io/bam.py`, unchanged: the
same header, record and index bytes.

Reference analog: src/c++/include/bam/Bam.hh (serializeHeader /
serializeAlignment), include/bam/BamIndexer.hh (.bai built inline with
serialization) and io/FileSinkWithMd5.hh (md5 of the output stream).
A minimal BAM reader lives here too (reference BamParser analog) — used
for tests and later for BAM-input realignment.
"""

from __future__ import annotations

import hashlib
import struct
from pathlib import Path

from . import bgzf, sam

_CIGAR_OPS = "MIDNSHP=X"
_CIGAR_CODE = {op: i for i, op in enumerate(_CIGAR_OPS)}
_SEQ_NIBBLE = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}
_NIBBLE_SEQ = "=ACMGRSVTWYHKDBN"


def parse_cigar(cigar: str) -> list[tuple[int, str]]:
    out = []
    num = ""
    for ch in cigar:
        if ch.isdigit():
            num += ch
        else:
            out.append((int(num), ch))
            num = ""
    return out


def reg2bin(beg: int, end: int) -> int:
    """SAM spec distributed binning (BamIndexer analog)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def _ref_len_from_cigar(cigar: list[tuple[int, str]]) -> int:
    return sum(n for n, op in cigar if op in "MDN=X")


def record_bytes(rec: sam.SamRecord, ref_ids: dict[str, int]) -> bytes:
    """Serialize one alignment record (bam::serializeAlignment analog)."""
    ref_id = ref_ids.get(rec.rname, -1)
    pos = rec.pos - 1
    next_ref = ref_ids.get(rec.rnext if rec.rnext != "=" else rec.rname, -1)
    next_pos = rec.pnext - 1
    name = rec.qname.encode() + b"\x00"
    cigar = parse_cigar(rec.cigar) if rec.cigar != "*" else []
    cigar_b = b"".join(struct.pack("<I", (n << 4) | _CIGAR_CODE[op])
                       for n, op in cigar)
    seq = rec.seq if rec.seq != "*" else ""
    l_seq = len(seq)
    seq_b = bytearray((l_seq + 1) // 2)
    for i, ch in enumerate(seq):
        nib = _SEQ_NIBBLE.get(ch.upper(), 15)
        seq_b[i // 2] |= nib << (4 if i % 2 == 0 else 0)
    if rec.qual != "*" and rec.qual:
        qual_b = bytes((min(ord(c) - 33, 93) for c in rec.qual))
    else:
        qual_b = b"\xff" * l_seq

    tags_b = b""
    for tname, (typ, value) in sorted(rec.tags.items()):
        tb = tname.encode()
        if typ == "i":
            tags_b += tb + b"i" + struct.pack("<i", int(value))
        elif typ == "Z":
            tags_b += tb + b"Z" + str(value).encode() + b"\x00"
        elif typ == "A":
            tags_b += tb + b"A" + str(value)[:1].encode()
        elif typ == "f":
            tags_b += tb + b"f" + struct.pack("<f", float(value))

    end = pos + max(1, _ref_len_from_cigar(cigar))
    bin_ = reg2bin(pos, end) if ref_id >= 0 and pos >= 0 else 4680
    body = struct.pack(
        "<iiBBHHHiiii", ref_id, pos, len(name), rec.mapq, bin_,
        len(cigar), rec.flag, l_seq, next_ref, next_pos, rec.tlen)
    body += name + cigar_b + bytes(seq_b) + qual_b + tags_b
    return struct.pack("<i", len(body)) + body


def header_bytes(contigs, header_text: str | None = None,
                 **header_kw) -> bytes:
    text = ("\n".join(sam.header_lines(contigs, **header_kw)) + "\n"
            if header_text is None else header_text)
    out = b"BAM\x01" + struct.pack("<i", len(text)) + text.encode()
    out += struct.pack("<i", len(contigs))
    for c in contigs:
        name = c.name.encode() + b"\x00"
        out += struct.pack("<i", len(name)) + name + struct.pack("<i", c.length)
    return out


def bai_bytes(n_refs: int, ref, pos, end, v0, v1) -> bytes:
    """Vectorized .bai construction from per-record span columns.

    Reference analog: include/bam/BamIndexer.hh (built inline with
    serialization).  Callers pass records in file order; adjacent records
    in the same (ref, bin) merge into one chunk, and the 16kb linear
    index takes the min start voff per window with gap forward-fill.
    """
    import numpy as np

    mapped = (ref >= 0) & (pos >= 0)
    r, p, e = ref[mapped], pos[mapped], end[mapped]
    s0, s1 = v0[mapped], v1[mapped]
    from ..build.records import reg2bin_vec
    bins = reg2bin_vec(p, e) if len(p) else np.zeros(0, np.int64)

    # chunk merging: stable sort by (ref, bin) keeping file order
    order = np.lexsort((np.arange(len(r)), bins, r))
    rs, bsrt, c0, c1 = r[order], bins[order], s0[order], s1[order]
    if len(rs):
        new_grp = np.empty(len(rs), bool)
        new_grp[0] = True
        new_grp[1:] = (rs[1:] != rs[:-1]) | (bsrt[1:] != bsrt[:-1])
        new_chunk = new_grp | np.concatenate([[True], c0[1:] != c1[:-1]])
        ci = np.nonzero(new_chunk)[0]
        chunk_ref = rs[ci]
        chunk_bin = bsrt[ci]
        chunk_beg = c0[ci]
        chunk_end = c1[np.concatenate([ci[1:], [len(rs)]]) - 1]
    else:
        chunk_ref = chunk_bin = chunk_beg = chunk_end = np.zeros(0, np.int64)

    # linear index: min voff per 16kb window touched
    out = [b"BAI\x01" + struct.pack("<i", n_refs)]
    w0 = p >> 14
    w1 = np.maximum(e - 1, p) >> 14
    max_d = int((w1 - w0).max()) if len(p) else 0
    for rid in range(n_refs):
        rm = r == rid
        cm = chunk_ref == rid
        ub = np.unique(chunk_bin[cm])
        out.append(struct.pack("<i", len(ub)))
        for b in ub:
            sel = cm & (chunk_bin == b)
            n_ch = int(sel.sum())
            out.append(struct.pack("<Ii", int(b), n_ch))
            pair = np.empty((n_ch, 2), "<u8")
            pair[:, 0] = chunk_beg[sel]
            pair[:, 1] = chunk_end[sel]
            out.append(pair.tobytes())
        if rm.any():
            n_intv = int(w1[rm].max()) + 1
            lin = np.full(n_intv, np.iinfo(np.int64).max, np.int64)
            for d in range(max_d + 1):
                m = rm & (w0 + d <= w1)
                if m.any():
                    np.minimum.at(lin, (w0[m] + d), s0[m])
            # forward-fill gaps with the previous value (0 before first)
            has = lin != np.iinfo(np.int64).max
            idx = np.where(has, np.arange(n_intv), -1)
            idx = np.maximum.accumulate(idx)
            lin = np.where(idx >= 0, lin[np.maximum(idx, 0)], 0)
            out.append(struct.pack("<i", n_intv))
            out.append(lin.astype("<u8").tobytes())
        else:
            out.append(struct.pack("<i", 0))
    return b"".join(out)


class BamWriter:
    """Streaming BAM writer: records go out in bounded memory.

    The out-of-core half of the reference's Build phase
    (lib/build/Build.cpp:509-903 serializes bin by bin into per-sample
    BGZF streams): callers feed coordinate-ordered record batches; full
    BGZF blocks compress and hit disk as they fill, .bai virtual offsets
    and the md5 accumulate along the way.  The hot path is
    `write_fragment_batch` (columnar, fully vectorized); the SamRecord
    `write` path remains for tests/small outputs.
    """

    def __init__(self, path: str | Path, contigs, write_index: bool = True,
                 write_md5: bool = True, compression_level: int = 1,
                 threads: int = 4, **header_kw):
        self.path = Path(path)
        self.contigs = contigs
        self.ref_ids = {c.name: c.index for c in contigs}
        self.level = compression_level
        self.threads = threads
        self.write_index = write_index
        self.write_md5 = write_md5
        self._pending = bytearray(header_bytes(contigs, **header_kw))
        self._u_base = 0                    # uncompressed offset of pending[0]
        self._comp_starts: list[int] = []   # compressed start per BGZF block
        self._c_off = 0
        # span columns: (ref_id, pos, end, u0, u1) as parallel arrays
        self._spans: list[tuple] = []
        self._f = open(self.path, "wb")
        self._md5 = hashlib.md5()
        self._closed = False

    def write(self, records: list[sam.SamRecord]) -> None:
        import numpy as np
        cols = ([], [], [], [], [])
        for rec in records:
            u0 = self._u_base + len(self._pending)
            self._pending += record_bytes(rec, self.ref_ids)
            if self.write_index:
                ref_id = self.ref_ids.get(rec.rname, -1)
                pos = rec.pos - 1
                cig = parse_cigar(rec.cigar) if rec.cigar != "*" else []
                end = pos + max(1, _ref_len_from_cigar(cig))
                for c, v in zip(cols, (ref_id, pos, end, u0,
                                       self._u_base + len(self._pending))):
                    c.append(v)
        if self.write_index and cols[0]:
            self._spans.append(tuple(np.asarray(c, np.int64) for c in cols))
        self._flush_full_blocks()

    def write_fragment_batch(self, fb) -> None:
        """Vectorized columnar write (build/records.to_bam_bytes)."""
        import numpy as np

        from ..build.records import to_bam_bytes
        data, u0, u1, ref_end = to_bam_bytes(fb)
        if not data:
            return
        base = self._u_base + len(self._pending)
        self._pending += data
        if self.write_index:
            pos = np.where(fb.ref_id >= 0, fb.pos, -1).astype(np.int64)
            self._spans.append((fb.ref_id.astype(np.int64), pos,
                                ref_end.astype(np.int64),
                                u0 + base, u1 + base))
        self._flush_full_blocks()

    def _flush_full_blocks(self) -> None:
        bs = bgzf.BLOCK_SIZE
        n_full = (len(self._pending) // bs) * bs
        if not n_full:
            return
        chunk = bytes(self._pending[:n_full])
        del self._pending[:n_full]
        self._u_base += n_full
        stream, blocks = bgzf.compress(chunk, level=self.level,
                                       threads=self.threads)
        for _u, clen in blocks:
            self._comp_starts.append(self._c_off)
            self._c_off += clen
        self._f.write(stream)
        self._md5.update(stream)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._pending:
            stream, _ = bgzf.compress(bytes(self._pending), level=self.level,
                                      threads=self.threads)
            self._comp_starts.append(self._c_off)
            self._c_off += len(stream)
            self._f.write(stream)
            self._md5.update(stream)
            self._u_base += len(self._pending)
            self._pending.clear()
        self._f.write(bgzf.EOF_BLOCK)
        self._md5.update(bgzf.EOF_BLOCK)
        self._f.close()
        if self.write_md5:
            Path(str(self.path) + ".md5").write_text(
                f"{self._md5.hexdigest()}  {self.path.name}\n")
        if self.write_index:
            import numpy as np
            if self._spans:
                ref, pos, end, u0, u1 = (
                    np.concatenate([s[i] for s in self._spans])
                    for i in range(5))
            else:
                ref = pos = end = u0 = u1 = np.zeros(0, np.int64)
            bs = bgzf.BLOCK_SIZE
            comp = np.asarray(self._comp_starts or [0], np.int64)

            def voff(u: np.ndarray) -> np.ndarray:
                b = u // bs
                over = b >= len(self._comp_starts)
                starts = comp[np.minimum(b, len(comp) - 1)]
                return np.where(over, self._c_off << 16,
                                (starts << 16) | (u - b * bs))

            data = bai_bytes(len(self.contigs), ref, pos, end,
                             voff(u0), voff(u1))
            Path(str(self.path) + ".bai").write_bytes(data)

    def __enter__(self) -> "BamWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def write_bam(path: str | Path, records: list[sam.SamRecord], contigs,
              write_index: bool = True, write_md5: bool = True,
              compression_level: int = 1, threads: int = 4,
              **header_kw) -> None:
    """Write records (must be coordinate-sorted for a valid .bai) to BAM."""
    with BamWriter(path, contigs, write_index=write_index,
                   write_md5=write_md5, compression_level=compression_level,
                   threads=threads, **header_kw) as w:
        w.write(records)


# ---------------------------------------------------------------------------
# Minimal BAM reader (reference BamParser.hh analog; tests + BAM input)
# ---------------------------------------------------------------------------

def read_bam(path: str | Path):
    """Parse a BAM file -> (header_text, contigs(name,length), records)."""
    data = bgzf.decompress(Path(path).read_bytes())
    if data[:4] != b"BAM\x01":
        raise ValueError("not a BAM file")
    l_text = struct.unpack("<i", data[4:8])[0]
    text = data[8 : 8 + l_text].decode()
    off = 8 + l_text
    n_ref = struct.unpack("<i", data[off : off + 4])[0]
    off += 4
    refs = []
    for _ in range(n_ref):
        l_name = struct.unpack("<i", data[off : off + 4])[0]
        name = data[off + 4 : off + 4 + l_name - 1].decode()
        l_ref = struct.unpack("<i", data[off + 4 + l_name : off + 8 + l_name])[0]
        refs.append((name, l_ref))
        off += 8 + l_name

    records = []
    while off < len(data):
        block_size = struct.unpack("<i", data[off : off + 4])[0]
        body = data[off + 4 : off + 4 + block_size]
        off += 4 + block_size
        (ref_id, pos, l_rn, mapq, _bin, n_cig, flag, l_seq, nref, npos,
         tlen) = struct.unpack("<iiBBHHHiiii", body[:32])
        p = 32
        qname = body[p : p + l_rn - 1].decode()
        p += l_rn
        cigar = ""
        for _ in range(n_cig):
            v = struct.unpack("<I", body[p : p + 4])[0]
            cigar += f"{v >> 4}{_CIGAR_OPS[v & 0xF]}"
            p += 4
        seq = ""
        for i in range(l_seq):
            b = body[p + i // 2]
            seq += _NIBBLE_SEQ[(b >> 4) if i % 2 == 0 else (b & 0xF)]
        p += (l_seq + 1) // 2
        qual = "".join(chr(min(q, 93) + 33) for q in body[p : p + l_seq])
        p += l_seq
        tags = {}
        while p < len(body):
            tname = body[p : p + 2].decode()
            typ = chr(body[p + 2])
            p += 3
            if typ in "cC":
                tags[tname] = ("i", body[p]); p += 1
            elif typ in "sS":
                tags[tname] = ("i", struct.unpack("<h", body[p : p + 2])[0]); p += 2
            elif typ in "iI":
                tags[tname] = ("i", struct.unpack("<i", body[p : p + 4])[0]); p += 4
            elif typ == "f":
                tags[tname] = ("f", struct.unpack("<f", body[p : p + 4])[0]); p += 4
            elif typ == "Z":
                z = body.index(0, p)
                tags[tname] = ("Z", body[p:z].decode()); p = z + 1
            elif typ == "A":
                tags[tname] = ("A", chr(body[p])); p += 1
            else:
                raise ValueError(f"unsupported tag type {typ}")
        rname = refs[ref_id][0] if ref_id >= 0 else "*"
        rnext = ("=" if nref == ref_id else refs[nref][0]) if nref >= 0 else "*"
        records.append(sam.SamRecord(
            qname=qname, flag=flag, rname=rname, pos=pos + 1, mapq=mapq,
            cigar=cigar or "*", rnext=rnext, pnext=npos + 1, tlen=tlen,
            seq=seq or "*", qual=qual or "*", tags=tags))
    return text, refs, records
