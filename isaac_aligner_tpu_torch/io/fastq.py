"""FASTQ reading into fixed-shape read batches.

The port's own copy of the parts of `isaac_aligner_tpu/io/fastq.py` that
it calls, unchanged (the streaming and columnar readers come with the
workflow).  Reference analog: src/c++/include/io/FastqReader.hh.  The
pipeline wants rectangular [batch, read_len] uint8 arrays; reads shorter
than read_len are padded with N / quality 0 (padding bases never match and
carry no probability mass).
"""

from __future__ import annotations

import dataclasses
import gzip
import io
from pathlib import Path

import numpy as np

from .. import dna


@dataclasses.dataclass
class ReadBatch:
    """A rectangular batch of reads (one 'tile' in reference terms)."""

    names: list[str]
    bases: np.ndarray    # uint8 [B, L] codes 0..4
    quals: np.ndarray    # uint8 [B, L] phred (0 for padding)
    lengths: np.ndarray  # int32 [B] true read lengths

    @property
    def count(self) -> int:
        return int(self.bases.shape[0])

    @property
    def read_len(self) -> int:
        return int(self.bases.shape[1])


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
