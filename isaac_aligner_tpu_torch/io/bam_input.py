"""BAM input: realign reads from an existing BAM file.

The port's own copy of `isaac_aligner_tpu/io/bam_input.py`, unchanged in
output, with two loops made linear: the streamed reader walks an offset
through each decompressed chunk (the original slices the chunk's tail off
after every record, copying it: quadratic in the chunk's ~32 MB), and
`reads_from_bam` keeps the names it has seen in a set beside the ordered
list (the original scans the list for each record).

Reference analog: BamSeedSource + BamLoader/BamParser
(src/c++/include/workflow/alignWorkflow/BamDataSource.hh:41-155,
include/bam/BamParser.hh:130-194): reads come back in ORIGINAL strand
orientation (reverse-flagged records store the reverse complement, so we
undo it), pairs are matched by name + READ1/READ2 flags, and secondary/
supplementary records are skipped.

Two surfaces:
- `iter_bam_batches` STREAMS BGZF members chunk by chunk with
  cross-chunk pair matching (the reference's BamClusterLoader pair
  cache, BamDataSource.hh:41-155) — bounded RAM: one decompressed
  chunk + the pending-mate cache (small for collated/coordinate-sorted
  BAMs, where mates sit within one insert length of each other).
- `reads_from_bam` keeps the whole-file convenience API (fixtures).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from .. import dna
from . import sam
from .bam import read_bam
from .fastq import ReadBatch, batch_from_reads, pad_batch

#: BAM seq nibble -> 2-bit code (=1,2,4,8 -> A,C,G,T; everything else N)
_NIB_TO_CODE = np.full(16, dna.N, np.uint8)
_NIB_TO_CODE[[1, 2, 4, 8]] = [0, 1, 2, 3]


def _iter_bgzf_decompressed(path: str | Path, members_per_chunk: int = 512):
    """Yield decompressed byte chunks, one per `members_per_chunk` BGZF
    members — never holds the whole file (io/bgzf.decompress does)."""
    with open(path, "rb") as f:
        buf = b""
        parts: list[bytes] = []
        while True:
            chunk = f.read(1 << 22)
            if not chunk and not buf:
                break
            buf += chunk
            off = 0
            while True:
                if len(buf) - off < 18:
                    break
                if buf[off : off + 4] != b"\x1f\x8b\x08\x04":
                    raise ValueError(f"{path}: bad BGZF member header")
                xlen = struct.unpack_from("<H", buf, off + 10)[0]
                # scan extra subfields for BC (BSIZE)
                bsize = None
                xo = off + 12
                xend = xo + xlen
                while xo + 4 <= xend:
                    si1, si2, slen = buf[xo], buf[xo + 1], struct.unpack_from(
                        "<H", buf, xo + 2)[0]
                    if si1 == 66 and si2 == 67:
                        bsize = struct.unpack_from("<H", buf, xo + 4)[0] + 1
                    xo += 4 + slen
                if bsize is None:
                    raise ValueError(f"{path}: BGZF member without BSIZE")
                if len(buf) - off < bsize:
                    break
                cdata = buf[off + 12 + xlen : off + bsize - 8]
                if cdata:
                    parts.append(zlib.decompress(cdata, -15))
                off += bsize
                if len(parts) >= members_per_chunk:
                    yield b"".join(parts)
                    parts = []
            buf = buf[off:]
            if not chunk:
                break
        if parts:
            yield b"".join(parts)


def _iter_bam_records_streaming(path: str | Path):
    """Yield (qname: bytes, flag: int, codes: np.uint8[l], quals:
    np.uint8[l]) per primary record, streaming (original orientation
    restored for reverse-flagged records)."""
    chunks = _iter_bgzf_decompressed(path)
    buf = b""
    for c in chunks:
        buf = c
        break
    else:
        raise ValueError(f"{path}: empty BAM")
    while len(buf) < 12:
        buf += next(chunks)
    if buf[:4] != b"BAM\x01":
        raise ValueError(f"{path}: not a BAM file")
    l_text = struct.unpack_from("<i", buf, 4)[0]

    def need(n):
        nonlocal buf
        while len(buf) < n:
            try:
                buf += next(chunks)
            except StopIteration:
                return False
        return True

    if not need(12 + l_text):
        raise ValueError(f"{path}: truncated header")
    off = 8 + l_text
    n_ref = struct.unpack_from("<i", buf, off)[0]
    off += 4
    for _ in range(n_ref):
        if not need(off + 8):
            raise ValueError(f"{path}: truncated reference list")
        l_name = struct.unpack_from("<i", buf, off)[0]
        if not need(off + 8 + l_name):
            raise ValueError(f"{path}: truncated reference list")
        off += 8 + l_name
    buf = buf[off:]
    off = 0

    def fill(n: int) -> bool:
        """At least n bytes from `off` on, or False at the end of the
        file; the consumed head is dropped only when a chunk is added."""
        nonlocal buf, off
        while len(buf) - off < n:
            try:
                nxt = next(chunks)
            except StopIteration:
                return False
            buf = buf[off:] + nxt
            off = 0
        return True

    while True:
        if not fill(4):
            if len(buf) > off:
                raise ValueError(f"{path}: trailing bytes")
            return
        bs = struct.unpack_from("<i", buf, off)[0]
        if not fill(4 + bs):
            raise ValueError(f"{path}: truncated record")
        rec = memoryview(buf)[off + 4 : off + 4 + bs]
        l_rn = rec[8]
        flag = struct.unpack_from("<H", rec, 14)[0]
        n_cig = struct.unpack_from("<H", rec, 12)[0]
        l_seq = struct.unpack_from("<i", rec, 16)[0]
        if not flag & (sam.FLAG_SECONDARY | sam.FLAG_SUPPLEMENTARY):
            qname = bytes(rec[32 : 32 + l_rn - 1])
            so = 32 + l_rn + 4 * n_cig
            sb = (l_seq + 1) // 2
            packed = np.frombuffer(rec[so : so + sb], np.uint8)
            nib = np.empty(2 * sb, np.uint8)
            nib[0::2] = packed >> 4
            nib[1::2] = packed & 0xF
            codes = _NIB_TO_CODE[nib[:l_seq]]
            quals = np.frombuffer(rec[so + sb : so + sb + l_seq],
                                  np.uint8).copy()
            if quals.size and quals[0] == 0xFF:
                quals = np.full(l_seq, 30, np.uint8)   # '*' qualities
            if flag & sam.FLAG_REVERSE:
                codes = dna.revcomp(codes)
                quals = quals[::-1]
            yield qname, flag, codes, quals
        off += 4 + bs


def iter_bam_batches(path: str | Path, batch_size: int):
    """Stream (b1, b2 | None, None) padded ReadBatch tuples from a BAM.

    Pairs match across chunk boundaries through a pending-mate cache
    and emit in COMPLETION order; orphans at EOF are dropped like the
    reference's BamClusterLoader.  Peak RAM is one batch + the cache."""
    pend1: dict[bytes, tuple] = {}
    pend2: dict[bytes, tuple] = {}
    names: list[str] = []
    s1: list = []
    q1: list = []
    s2: list = []
    q2: list = []
    paired_mode = None

    first_w = [None]

    def mk(nm, seqs, quals):
        w = max(len(x) for x in seqs)
        # stable batch width across the stream (one shape on the device),
        # mirroring the FASTQ stream's rule
        if first_w[0] is None:
            first_w[0] = w
        elif w > first_w[0]:
            raise ValueError(
                f"read length {w} exceeds the stream's first-batch "
                f"read length {first_w[0]} — BAM streams must not grow")
        w = first_w[0]
        bases = np.full((len(seqs), w), dna.N, np.uint8)
        qs = np.zeros((len(seqs), w), np.uint8)
        lens = np.zeros(len(seqs), np.int32)
        for i, (sc, qc) in enumerate(zip(seqs, quals)):
            bases[i, : len(sc)] = sc
            qs[i, : len(sc)] = qc
            lens[i] = len(sc)
        return pad_batch(ReadBatch(nm, bases, qs, lens), batch_size)

    def flush(final: bool):
        nonlocal names, s1, q1, s2, q2
        while len(names) >= batch_size or (final and names):
            take = min(batch_size, len(names))
            nm, names = names[:take], names[take:]
            a1, s1 = s1[:take], s1[take:]
            c1, q1 = q1[:take], q1[take:]
            b1 = mk(nm, a1, c1)
            if paired_mode:
                a2, s2 = s2[:take], s2[take:]
                c2, q2 = q2[:take], q2[take:]
                b2 = mk(nm, a2, c2)
            else:
                b2 = None
            yield b1, b2, None

    for qname, flag, codes, quals in _iter_bam_records_streaming(path):
        if flag & sam.FLAG_PAIRED:
            if paired_mode is None:
                paired_mode = True
            mine, other = ((pend2, pend1) if flag & sam.FLAG_READ2
                           else (pend1, pend2))
            if qname in other:
                oc, oq = other.pop(qname)
                names.append(qname.decode("ascii"))
                if flag & sam.FLAG_READ2:
                    s1.append(oc); q1.append(oq)
                    s2.append(codes); q2.append(quals)
                else:
                    s1.append(codes); q1.append(quals)
                    s2.append(oc); q2.append(oq)
            else:
                mine.setdefault(qname, (codes, quals))
        else:
            if paired_mode is None:
                paired_mode = False
            names.append(qname.decode("ascii"))
            s1.append(codes)
            q1.append(quals)
        if len(names) >= batch_size:
            yield from flush(False)
    yield from flush(True)


def reads_from_bam(path: str | Path) -> tuple[ReadBatch, ReadBatch | None]:
    """Extract reads from a BAM -> (read1 batch, read2 batch or None)."""
    _text, _refs, records = read_bam(path)
    r1: dict[str, tuple[str, str]] = {}
    r2: dict[str, tuple[str, str]] = {}
    order: list[str] = []
    in_order: set[str] = set()
    paired = False
    for rec in records:
        if rec.flag & (sam.FLAG_SECONDARY | sam.FLAG_SUPPLEMENTARY):
            continue
        seq, qual = rec.seq, rec.qual
        if rec.flag & sam.FLAG_REVERSE and seq != "*":
            seq = dna.decode(dna.revcomp(dna.encode(seq)))
            qual = qual[::-1]
        if rec.flag & sam.FLAG_PAIRED:
            paired = True
            bucket = r2 if rec.flag & sam.FLAG_READ2 else r1
        else:
            bucket = r1
        bucket.setdefault(rec.qname, (seq, qual))
        if rec.qname not in in_order:
            in_order.add(rec.qname)
            order.append(rec.qname)

    # keep only complete entries, preserving first-seen order
    seen = set()
    names = []
    for n in order:
        if n in seen:
            continue
        seen.add(n)
        if paired and (n not in r1 or n not in r2):
            continue  # orphan record in a paired BAM: drop (reference skips)
        names.append(n)
    if not names:
        raise ValueError(f"{path}: no usable reads")

    b1 = batch_from_reads(names, [r1[n][0] for n in names],
                          [r1[n][1] for n in names])
    if not paired:
        return b1, None
    b2 = batch_from_reads(names, [r2[n][0] for n in names],
                          [r2[n][1] for n in names])
    return b1, b2
