"""FASTA reading and the in-memory Genome model.

The port's own copy of the parts of `isaac_aligner_tpu/io/fasta.py` that it
calls, unchanged.  Reference analog: src/c++/include/io/FastaReader.hh and
src/c++/include/reference/Contig.hh / ContigLoader.hh.  The whole genome is
ONE concatenated uint8 code array plus contig offset metadata, the layout
that device kernels index with flat global positions.
"""

from __future__ import annotations

import dataclasses
import gzip
import hashlib
import io
from pathlib import Path

import numpy as np

from .. import dna


@dataclasses.dataclass(frozen=True)
class ContigMeta:
    """Per-contig metadata (reference: SortedReferenceMetadata::Contig,
    src/c++/include/reference/SortedReferenceMetadata.hh:35-120)."""

    index: int
    name: str
    offset: int          # start in the concatenated genome array
    length: int
    md5: str

    @property
    def end(self) -> int:
        return self.offset + self.length


@dataclasses.dataclass
class Genome:
    """Concatenated reference genome as a flat uint8 code array."""

    codes: np.ndarray                 # uint8 [G], values 0..4
    contigs: list[ContigMeta]

    @property
    def total_length(self) -> int:
        return int(self.codes.shape[0])

    @property
    def contig_offsets(self) -> np.ndarray:
        return np.array([c.offset for c in self.contigs], dtype=np.int64)

    def contig_of(self, global_pos: int) -> ContigMeta:
        idx = int(np.searchsorted(self.contig_offsets, global_pos, side="right")) - 1
        return self.contigs[idx]

    def slice(self, global_pos: int, length: int) -> np.ndarray:
        return self.codes[global_pos : global_pos + length]

    def to_local(self, global_pos: int) -> tuple[str, int]:
        """Global 0-based position -> (contig name, 0-based local position)."""
        c = self.contig_of(global_pos)
        return c.name, int(global_pos - c.offset)


def _open_maybe_gzip(path: str | Path) -> io.BufferedReader:
    path = Path(path)
    f = open(path, "rb")
    if f.peek(2)[:2] == b"\x1f\x8b":
        return gzip.open(f)  # type: ignore[return-value]
    return f


def read_fasta(path: str | Path) -> Genome:
    """Parse a (possibly gzipped) FASTA file into a Genome."""
    names: list[str] = []
    chunks: list[list[bytes]] = []
    with _open_maybe_gzip(path) as f:
        for raw in f:
            line = raw.strip()
            if not line:
                continue
            if line.startswith(b">"):
                names.append(line[1:].split()[0].decode("ascii"))
                chunks.append([])
            else:
                if not names:
                    raise ValueError(f"{path}: sequence data before first '>' header")
                chunks[-1].append(line)
    return genome_from_sequences([(n, b"".join(c)) for n, c in zip(names, chunks)])


def genome_from_sequences(seqs: list[tuple[str, str | bytes]]) -> Genome:
    """Build a Genome from (name, sequence) pairs (test fixtures use this)."""
    contigs: list[ContigMeta] = []
    arrays: list[np.ndarray] = []
    offset = 0
    for i, (name, seq) in enumerate(seqs):
        if isinstance(seq, str):
            seq = seq.encode("ascii")
        codes = dna.encode(seq)
        # md5 of the uppercased base letters, like samtools/reference headers
        md5 = hashlib.md5(dna.decode(codes).encode("ascii")).hexdigest()
        contigs.append(ContigMeta(index=i, name=name, offset=offset,
                                  length=len(codes), md5=md5))
        arrays.append(codes)
        offset += len(codes)
    if not arrays:
        raise ValueError("empty FASTA")
    return Genome(codes=np.concatenate(arrays), contigs=contigs)
