"""FASTQ reading into fixed-shape read batches.

The port's own copy of `isaac_aligner_tpu/io/fastq.py`, unchanged apart
from `iter_fastq_batches`, which refuses a barcode FASTQ (demultiplexing,
ROADMAP queue A item 10).  Reference analog:
src/c++/include/io/FastqReader.hh and the FastqSeedSource tile synthesis
(src/c++/include/workflow/alignWorkflow/FastqDataSource.hh).  The pipeline
wants rectangular [batch, read_len] uint8 arrays; reads shorter than
read_len are padded with N / quality 0 (padding bases never match and
carry no probability mass).
"""

from __future__ import annotations

import dataclasses
import gzip
import io
from pathlib import Path

import numpy as np

from .. import dna


class LazyNames:
    """Columnar read names: ascii byte matrix [B, W] + lengths, with
    lazy Python-string materialization.

    The e2e hot path (FASTQ parse -> convert -> BAM name column) never
    needs Python string objects — building 32k strs per batch plus the
    downstream `startswith("__pad")` scans held the GIL long enough to
    starve the 2-core pipeline (round-5 profile).  Rows at index >=
    `pad_from` are synthetic "__pad{i}" padding rows (their matrix rows
    hold the same ascii).  Supports list-compatible indexing/iteration
    (materializes on demand) so fixture/SAM paths keep working.
    """

    __slots__ = ("mat", "lens", "pad_from", "_strs")

    def __init__(self, mat: np.ndarray, lens: np.ndarray,
                 pad_from: int | None = None):
        self.mat = mat
        self.lens = lens.astype(np.int32)
        self.pad_from = mat.shape[0] if pad_from is None else int(pad_from)
        self._strs: list[str] | None = None

    @staticmethod
    def from_list(names: list[str]) -> "LazyNames":
        arr = np.array(names, dtype="S") if names else np.zeros(0, "S1")
        w = max(1, arr.dtype.itemsize)
        mat = arr.view(np.uint8).reshape(len(names), w)
        lens = np.char.str_len(arr).astype(np.int32)
        pad = len(names)
        for i in range(len(names) - 1, -1, -1):
            if names[i].startswith("__pad"):
                pad = i
            else:
                break
        ln = LazyNames(mat, lens, pad)
        ln._strs = list(names)
        return ln

    def _materialize(self) -> list[str]:
        if self._strs is None:
            flat = self.mat.tobytes()
            w = self.mat.shape[1]
            lens = self.lens
            self._strs = [flat[i * w : i * w + lens[i]].decode("ascii")
                          for i in range(self.mat.shape[0])]
        return self._strs

    def __len__(self) -> int:
        return int(self.mat.shape[0])

    def __getitem__(self, i):
        if isinstance(i, slice):
            start, stop, step = i.indices(len(self))
            if step == 1:
                out = LazyNames(self.mat[i], self.lens[i],
                                min(max(self.pad_from - start, 0),
                                    stop - start))
                if self._strs is not None:
                    out._strs = self._strs[i]
                return out
            return self._materialize()[i]
        if self._strs is not None:
            return self._strs[i]
        row = bytes(self.mat[i, : self.lens[i]])
        return row.decode("ascii")

    def __iter__(self):
        return iter(self._materialize())

    def __add__(self, other: list[str]):
        return self._materialize() + list(other)

    def __eq__(self, other):
        if isinstance(other, LazyNames):
            other = other._materialize()
        if isinstance(other, list):
            return self._materialize() == other
        return NotImplemented

    def matrix(self, idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(byte matrix, lengths) for the selected rows — no strings."""
        return self.mat[idx], self.lens[idx]

    def with_padding(self, to_count: int) -> "LazyNames":
        """Append "__pad{i}" rows up to `to_count` (columnar pad_batch)."""
        n = len(self)
        pad = to_count - n
        if pad <= 0:
            return self
        pnames = np.array([f"__pad{i}" for i in range(pad)], dtype="S")
        pw = pnames.dtype.itemsize
        w = max(self.mat.shape[1], pw)
        mat = np.zeros((to_count, w), np.uint8)
        mat[:n, : self.mat.shape[1]] = self.mat
        mat[n:, :pw] = pnames.view(np.uint8).reshape(pad, pw)
        lens = np.concatenate(
            [self.lens, np.char.str_len(pnames).astype(np.int32)])
        return LazyNames(mat, lens, min(self.pad_from, n))


@dataclasses.dataclass
class ReadBatch:
    """A rectangular batch of reads (one 'tile' in reference terms)."""

    names: "list[str] | LazyNames"
    bases: np.ndarray    # uint8 [B, L] codes 0..4
    quals: np.ndarray    # uint8 [B, L] phred (0 for padding)
    lengths: np.ndarray  # int32 [B] true read lengths

    @property
    def count(self) -> int:
        return int(self.bases.shape[0])

    @property
    def read_len(self) -> int:
        return int(self.bases.shape[1])

    @property
    def n_valid(self) -> int:
        """Rows before the first "__pad" padding row."""
        if isinstance(self.names, LazyNames):
            return self.names.pad_from
        n = len(self.names)
        while n > 0 and self.names[n - 1].startswith("__pad"):
            n -= 1
        return n


def _open_maybe_gzip(path: str | Path) -> io.BufferedReader:
    f = open(Path(path), "rb")
    if f.peek(2)[:2] == b"\x1f\x8b":
        return gzip.open(f)  # type: ignore[return-value]
    return f


def read_fastq(path: str | Path, phred_offset: int = 33) -> ReadBatch:
    names: list[str] = []
    seqs: list[bytes] = []
    quals: list[bytes] = []
    with _open_maybe_gzip(path) as f:
        while True:
            header = f.readline()
            if not header:
                break
            header = header.strip()
            if not header:
                continue
            if not header.startswith(b"@"):
                raise ValueError(f"{path}: malformed FASTQ header {header!r}")
            seq = f.readline().strip()
            plus = f.readline().strip()
            qual = f.readline().strip()
            if not plus.startswith(b"+"):
                raise ValueError(f"{path}: malformed FASTQ separator {plus!r}")
            if len(seq) != len(qual):
                raise ValueError(f"{path}: seq/qual length mismatch for {header!r}")
            names.append(header[1:].split()[0].decode("ascii"))
            seqs.append(seq)
            quals.append(qual)
    return batch_from_reads(names, seqs, quals, phred_offset=phred_offset)


def batch_from_reads(
    names: list[str],
    seqs: list[str | bytes],
    quals: list[str | bytes] | None = None,
    phred_offset: int = 33,
    default_q: int = 30,
) -> ReadBatch:
    """Build a rectangular ReadBatch from python read lists (fixture entry)."""
    seqs_b = [s.encode("ascii") if isinstance(s, str) else bytes(s) for s in seqs]
    n = len(seqs_b)
    max_len = max((len(s) for s in seqs_b), default=0)
    # uniform-length fast path (the overwhelmingly common case): one
    # C-level join + table lookup instead of a per-read loop
    if n and quals is not None and all(len(s) == max_len for s in seqs_b):
        quals_b = [qi.encode("ascii") if isinstance(qi, str) else bytes(qi)
                   for qi in quals]
        if all(len(qi) == max_len for qi in quals_b):
            bases = dna.BASE_TO_CODE[
                np.frombuffer(b"".join(seqs_b), np.uint8)].reshape(n, max_len)
            q = (np.frombuffer(b"".join(quals_b), np.uint8)
                 .reshape(n, max_len) - phred_offset).astype(np.uint8)
            return ReadBatch(names=names, bases=bases.copy(), quals=q,
                             lengths=np.full(n, max_len, np.int32))
    bases = np.full((n, max_len), dna.N, dtype=np.uint8)
    q = np.zeros((n, max_len), dtype=np.uint8)
    lengths = np.zeros(n, dtype=np.int32)
    for i, s in enumerate(seqs_b):
        bases[i, : len(s)] = dna.encode(s)
        lengths[i] = len(s)
        if quals is not None:
            qi = quals[i]
            qi = qi.encode("ascii") if isinstance(qi, str) else bytes(qi)
            q[i, : len(s)] = np.frombuffer(qi, dtype=np.uint8) - phred_offset
        else:
            q[i, : len(s)] = default_q
    return ReadBatch(names=names, bases=bases, quals=q, lengths=lengths)


def iter_fastq_records(path: str | Path):
    """Stream (name, seq, qual) byte tuples — bounded memory."""
    with _open_maybe_gzip(path) as f:
        while True:
            header = f.readline()
            if not header:
                return
            header = header.strip()
            if not header:
                continue
            if not header.startswith(b"@"):
                raise ValueError(f"{path}: malformed FASTQ header {header!r}")
            seq = f.readline().strip()
            plus = f.readline().strip()
            qual = f.readline().strip()
            if not plus.startswith(b"+"):
                raise ValueError(f"{path}: malformed FASTQ separator {plus!r}")
            if len(seq) != len(qual):
                raise ValueError(f"{path}: seq/qual length mismatch for {header!r}")
            yield header[1:].split()[0].decode("ascii"), seq, qual


def iter_fastq_records_bulk(path: str | Path, chunk_bytes: int = 1 << 22):
    """Stream (name, seq, qual) byte tuples via bulk line splitting —
    ~6x faster than per-record readline (the FASTQ parse was a top-3
    cost of the end-to-end pipeline)."""
    with _open_maybe_gzip(path) as f:
        tail = b""
        lines: list[bytes] = []
        pos = 0
        while True:
            chunk = f.read(chunk_bytes)
            if not chunk:
                break
            block = tail + chunk
            new = block.split(b"\n")
            tail = new.pop()
            lines.extend(new)
            n_rec = (len(lines) - pos) // 4
            for _ in range(n_rec):
                header, seq, plus, qual = lines[pos : pos + 4]
                pos += 4
                if not header.startswith(b"@") or not plus.startswith(b"+"):
                    raise ValueError(f"{path}: malformed FASTQ record "
                                     f"{header!r}")
                if len(seq) != len(qual):
                    raise ValueError(
                        f"{path}: seq/qual length mismatch for {header!r}")
                yield header[1:].split()[0].decode("ascii"), seq, qual
            if pos:
                del lines[:pos]
                pos = 0
        rest = [ln for ln in lines + ([tail] if tail.strip() else [])
                if ln.strip()]
        for i in range(0, len(rest), 4):
            rec = rest[i : i + 4]
            if len(rec) < 4:
                raise ValueError(f"{path}: truncated FASTQ record at EOF")
            header, seq, plus, qual = rec
            if not header.startswith(b"@") or not plus.startswith(b"+"):
                raise ValueError(f"{path}: malformed FASTQ record {header!r}")
            if len(seq) != len(qual):
                raise ValueError(
                    f"{path}: seq/qual length mismatch for {header!r}")
            yield header[1:].split()[0].decode("ascii"), seq, qual


class _ColumnarFastqStream:
    """Chunked FASTQ reader that parses whole record blocks with numpy.

    Per batch of n records: one bulk read, ONE newline scan
    (np.flatnonzero), vectorized header/plus validation, and a single
    fancy-indexed gather of bases/quals — no per-record Python in the
    hot path (the per-record generator was a top-3 e2e cost).  Names
    decode in one cheap slicing loop (~2% of the old parse time).
    """

    def __init__(self, path: str | Path, phred_offset: int = 33,
                 chunk_bytes: int = 1 << 23):
        self.path = path
        self.f = _open_maybe_gzip(path)
        self.phred_offset = phred_offset
        self.chunk_bytes = chunk_bytes
        self._buf = b""
        self._nl_count = 0
        self._eof = False

    def close(self) -> None:
        self.f.close()

    def _fill(self, need_lines: int) -> None:
        while self._nl_count < need_lines and not self._eof:
            chunk = self.f.read(self.chunk_bytes)
            if not chunk:
                self._eof = True
                break
            self._nl_count += chunk.count(b"\n")
            self._buf = self._buf + chunk if self._buf else chunk

    def next_batch(self, n: int):
        """Parse up to n records; returns (names, bases, quals, lengths)
        or None at EOF."""
        self._fill(4 * n)
        buf = self._buf
        if not buf.strip():
            return None
        arr = np.frombuffer(buf, np.uint8)
        nl = np.flatnonzero(arr == 10)
        if self._eof and (nl.size == 0 or nl[-1] != arr.shape[0] - 1):
            # final record without trailing newline
            arr = np.frombuffer(buf + b"\n", np.uint8)
            nl = np.flatnonzero(arr == 10)
        n_rec = min(n, nl.size // 4)
        if n_rec == 0:
            raise ValueError(f"{self.path}: truncated FASTQ record at EOF")
        ends = nl[: 4 * n_rec]
        starts = np.empty_like(ends)
        starts[0] = 0
        starts[1:] = ends[:-1] + 1
        # consume the parsed span
        consumed = int(ends[-1]) + 1
        self._buf = buf[consumed:] if consumed < len(buf) else b""
        self._nl_count -= 4 * n_rec
        # strip \r for CRLF files
        ends = ends - (arr[np.maximum(ends - 1, 0)] == 13)

        h_s, h_e = starts[0::4], ends[0::4]
        s_s, s_e = starts[1::4], ends[1::4]
        p_s = starts[2::4]
        q_s, q_e = starts[3::4], ends[3::4]
        if not (arr[h_s] == ord("@")).all() or not (arr[p_s] == ord("+")).all():
            bad = int(np.flatnonzero((arr[h_s] != ord("@"))
                                     | (arr[p_s] != ord("+")))[0])
            raise ValueError(
                f"{self.path}: malformed FASTQ record "
                f"{buf[h_s[bad]:h_e[bad]]!r}")
        lengths = (s_e - s_s).astype(np.int64)
        if not (lengths == (q_e - q_s)).all():
            bad = int(np.flatnonzero(lengths != (q_e - q_s))[0])
            raise ValueError(f"{self.path}: seq/qual length mismatch for "
                             f"{buf[h_s[bad]:h_e[bad]]!r}")
        max_len = int(lengths.max()) if n_rec else 0
        col = np.arange(max_len, dtype=np.int64)[None, :]
        if int(lengths.min()) == max_len:
            # uniform read length (the common Illumina case): no masking
            bases = dna.BASE_TO_CODE[arr[s_s[:, None] + col]]
            quals = (arr[q_s[:, None] + col] - np.uint8(self.phred_offset))
        else:
            in_read = col < lengths[:, None]
            gather = np.minimum(s_s[:, None] + col, arr.shape[0] - 1)
            raw = arr[gather]
            bases = np.where(in_read, dna.BASE_TO_CODE[raw], np.uint8(dna.N))
            rawq = arr[np.minimum(q_s[:, None] + col, arr.shape[0] - 1)]
            quals = np.where(in_read, rawq - self.phred_offset,
                             0).astype(np.uint8)
        # names: header up to the first whitespace — columnar (LazyNames;
        # building 32k Python strings per batch held the GIL on the
        # 2-core e2e critical path)
        n_s = h_s + 1
        n_len = (h_e - n_s).astype(np.int64)
        w = max(1, int(n_len.max()) if n_rec else 1)
        ncol = np.arange(w, dtype=np.int64)[None, :]
        gather = np.minimum(n_s[:, None] + ncol, arr.shape[0] - 1)
        mat = np.where(ncol < n_len[:, None], arr[gather], np.uint8(0))
        ws = (mat == 32) | (mat == 9)
        has_ws = ws.any(axis=1)
        if has_ws.any():
            first_ws = np.argmax(ws, axis=1)
            n_len = np.where(has_ws, first_ws, n_len)
            mat = np.where(ncol < n_len[:, None], mat, np.uint8(0))
        names = LazyNames(mat, n_len.astype(np.int32))
        return names, bases, quals, lengths.astype(np.int32)


def iter_fastq_batches(path1: str | Path, path2: str | Path | None,
                       batch_size: int, phred_offset: int = 33,
                       barcode_path: str | Path | None = None):
    """Stream synchronized, padded ReadBatch tuples from FASTQ file(s).

    The out-of-core analog of the reference's FastqSeedSource tile
    synthesis (FastqDataSource.hh:41-118): yields (b1, b2 | None, None)
    with every batch padded to `batch_size` and each stream at its own
    stable read width, holding only one batch in RAM at a time.  Read-1
    and read-2 files of different read counts raise ValueError.  A barcode
    FASTQ (demultiplexing) is not ported (ROADMAP queue A item 10).
    """
    if barcode_path is not None:
        raise NotImplementedError(
            "barcode FASTQ input is not ported yet (ROADMAP queue A item 10)")
    st1 = _ColumnarFastqStream(path1, phred_offset)
    st2 = _ColumnarFastqStream(path2, phred_offset) if path2 else None
    widths = [None, None]         # stable per-stream read_len

    def _mk(parsed, slot: int) -> ReadBatch:
        names, bases, quals, lengths = parsed
        b = ReadBatch(names=names, bases=bases, quals=quals, lengths=lengths)
        if widths[slot] is None:
            widths[slot] = b.read_len
        return pad_batch(_widen(b, widths[slot]), batch_size)

    try:
        while True:
            chunk1 = st1.next_batch(batch_size)
            if chunk1 is None:
                if st2 is not None and st2.next_batch(1) is not None:
                    raise ValueError("fastq1/fastq2 read counts differ")
                return
            n1 = len(chunk1[0])
            b1 = _mk(chunk1, 0)
            b2 = None
            if st2 is not None:
                chunk2 = st2.next_batch(n1)
                if chunk2 is None or len(chunk2[0]) != n1:
                    raise ValueError("fastq1/fastq2 read counts differ")
                b2 = _mk(chunk2, 1)
            yield b1, b2, None
    finally:
        for st in (st1, st2):
            if st is not None:
                st.close()


def _widen(batch: ReadBatch, read_len: int) -> ReadBatch:
    """Pad a batch's read dimension with N / q0 out to `read_len`."""
    if batch.read_len == read_len:
        return batch
    if batch.read_len > read_len:
        raise ValueError(
            f"read length {batch.read_len} exceeds the stream's first-batch "
            f"read length {read_len} — mixed-length FASTQ streams must not "
            f"grow")
    bases = np.full((batch.count, read_len), dna.N, np.uint8)
    quals = np.zeros((batch.count, read_len), np.uint8)
    bases[:, : batch.read_len] = batch.bases
    quals[:, : batch.read_len] = batch.quals
    return ReadBatch(names=batch.names, bases=bases, quals=quals,
                     lengths=batch.lengths)


def estimate_fastq_reads(path: str | Path, gz_ratio: float = 4.0) -> int:
    """Cheap read-count estimate for bin sizing: average record size over
    the first 1000 records extrapolated by file size (gz inputs assume
    `gz_ratio` compression).  Only bin granularity depends on this —
    correctness never does."""
    path = Path(path)
    n = 0
    seen = 0
    for name, seq, qual in iter_fastq_records(path):
        seen += len(name) + len(seq) + len(qual) + 7
        n += 1
        if n >= 1000:
            break
    if n == 0:
        return 0
    size = path.stat().st_size
    with open(path, "rb") as f:
        if f.read(2) == b"\x1f\x8b":
            size = int(size * gz_ratio)
    return max(n, int(size / max(1, seen / n)))


def pad_batch(batch: ReadBatch, to_count: int) -> ReadBatch:
    """Pad a batch with empty reads up to a static batch size (every
    batch of a run reaches the device with one shape)."""
    b = batch.count
    if b == to_count:
        return batch
    if b > to_count:
        raise ValueError("pad_batch cannot shrink")
    pad = to_count - b
    names = (batch.names.with_padding(to_count)
             if isinstance(batch.names, LazyNames)
             else batch.names + [f"__pad{i}" for i in range(pad)])
    return ReadBatch(
        names=names,
        bases=np.concatenate([batch.bases, np.full((pad, batch.read_len), dna.N, np.uint8)]),
        quals=np.concatenate([batch.quals, np.zeros((pad, batch.read_len), np.uint8)]),
        lengths=np.concatenate([batch.lengths, np.zeros(pad, np.int32)]),
    )
