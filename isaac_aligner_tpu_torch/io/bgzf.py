"""BGZF (blocked gzip) compression/decompression.

The port's own copy of `isaac_aligner_tpu/io/bgzf.py`, unchanged; the
native library is the port's build of its own `native/bgzf.cpp`.

Reference analog: src/c++/lib/bgzf (BgzfCompressor/BgzfReader).  The hot
path is the parallel C++ library (native/bgzf.cpp); a pure-Python zlib
fallback keeps everything working without a toolchain.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from ..native import load_library

#: uncompressed payload per BGZF block (reference uses 0xff00)
BLOCK_SIZE = 0xFF00

#: BGZF EOF marker (empty final block, per SAM spec)
EOF_BLOCK = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def _compress_block_py(data: bytes, level: int) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    cdata = co.compress(data) + co.flush()
    bsize = len(cdata) + 26
    header = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00\x42\x43"
              b"\x02\x00" + struct.pack("<H", bsize - 1))
    footer = struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data))
    return header + cdata + footer


def compress(data: bytes, level: int = 1, threads: int = 4,
             block_size: int = BLOCK_SIZE) -> tuple[bytes, list[tuple[int, int]]]:
    """BGZF-compress `data`; returns (stream, blocks) where blocks lists
    (uncompressed_offset, compressed_member_length) per block — the info
    the .bai virtual-offset builder needs.  No EOF block appended."""
    n = len(data)
    if n == 0:
        return b"", []
    offsets = list(range(0, n, block_size)) + [n]
    n_blocks = len(offsets) - 1

    lib = load_library("bgzf")
    if lib is not None:
        stride = 65536 + 64
        inbuf = np.frombuffer(data, dtype=np.uint8)
        off_arr = np.asarray(offsets, dtype=np.int64)
        out = np.empty(n_blocks * stride, dtype=np.uint8)
        lens = np.zeros(n_blocks, dtype=np.int32)
        rc = lib.bgzf_compress_many(
            inbuf.ctypes.data_as(ctypes.c_void_p),
            off_arr.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int(n_blocks),
            out.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int64(stride),
            lens.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int(level),
            ctypes.c_int(threads),
        )
        if rc == 0:
            parts = [out[b * stride : b * stride + int(lens[b])].tobytes()
                     for b in range(n_blocks)]
            blocks = [(offsets[b], int(lens[b])) for b in range(n_blocks)]
            return b"".join(parts), blocks

    parts = []
    blocks = []
    for b in range(n_blocks):
        member = _compress_block_py(data[offsets[b] : offsets[b + 1]], level)
        blocks.append((offsets[b], len(member)))
        parts.append(member)
    return b"".join(parts), blocks


def decompress(stream: bytes) -> bytes:
    """Decompress a BGZF stream (concatenated gzip members)."""
    out = []
    pos = 0
    n = len(stream)
    while pos < n:
        if stream[pos : pos + 2] != b"\x1f\x8b":
            raise ValueError(f"bad BGZF magic at offset {pos}")
        xlen = struct.unpack("<H", stream[pos + 10 : pos + 12])[0]
        # find BC subfield for the member size
        extra = stream[pos + 12 : pos + 12 + xlen]
        bsize = None
        i = 0
        while i + 4 <= len(extra):
            si1, si2, slen = extra[i], extra[i + 1], struct.unpack("<H", extra[i + 2 : i + 4])[0]
            if si1 == 0x42 and si2 == 0x43:
                bsize = struct.unpack("<H", extra[i + 4 : i + 6])[0] + 1
                break
            i += 4 + slen
        if bsize is None:
            raise ValueError("BGZF member missing BC subfield")
        cdata = stream[pos + 12 + xlen : pos + bsize - 8]
        out.append(zlib.decompress(cdata, -15))
        pos += bsize
    return b"".join(out)
