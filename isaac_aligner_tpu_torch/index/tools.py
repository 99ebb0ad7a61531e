"""Auxiliary reference-index tools.

The port's own copy of `isaac_aligner_tpu/index/tools.py` (host numpy),
unchanged.  Reference analogs (src/c++/libexec + lib/workflow aux
workflows):
- extract_neighbor_bitmap  <- ExtractNeighborsWorkflow (genome-neighbors.1bpb:
  one bit per genome position) + BpbToWigWorkflow (bitmap -> wig text)
- merge_indexes            <- MergeReferencesWorkflow (merge per-shard builds
  of disjoint contig sets into one multi-contig index)
- reorder_reference        <- ReorderReferenceWorkflow (karyotype contig
  reorder with position remapping)
- pack_reference / unpack_reference <- isaac-pack/unpack-reference
  (relocatable tar.gz of the index directory)
"""

from __future__ import annotations

import tarfile
from pathlib import Path

import numpy as np

from ..io.fasta import ContigMeta, Genome
from .build import SeedIndex, TOO_MANY_POS


def extract_neighbor_bitmap(index: SeedIndex) -> np.ndarray:
    """Per-genome-position neighbor bits, packed 8 positions per byte
    (reference genome-neighbors.1bpb format, ExtractNeighborsWorkflow)."""
    g = index.genome.total_length
    bits = np.zeros(g, np.uint8)
    if index.has_neighbors is not None:
        mask = (index.pos != TOO_MANY_POS) & (index.has_neighbors != 0)
        bits[index.pos[mask]] = 1
    return np.packbits(bits)


def bitmap_to_wig(bitmap: np.ndarray, genome: Genome, out_path: str | Path,
                  track_name: str = "neighbors") -> None:
    """1-bit-per-base bitmap -> UCSC wiggle text (BpbToWigWorkflow)."""
    bits = np.unpackbits(bitmap)[: genome.total_length]
    with open(out_path, "w") as f:
        f.write(f'track type=wiggle_0 name="{track_name}"\n')
        for c in genome.contigs:
            f.write(f"fixedStep chrom={c.name} start=1 step=1\n")
            seg = bits[c.offset : c.end]
            f.write("\n".join(map(str, seg.tolist())))
            f.write("\n")


def merge_indexes(parts: list[SeedIndex]) -> SeedIndex:
    """Merge indexes built over DISJOINT contig sets into one.

    The parts' genomes concatenate in the given order; record positions
    re-offset, then a k-way merge by key restores global sort order
    (MergeReferencesWorkflow analog for the whole-genome planes).
    """
    if not parts:
        raise ValueError("nothing to merge")
    seed_len = parts[0].seed_len
    names = set()
    for p in parts:
        if p.seed_len != seed_len:
            raise ValueError("seed lengths differ between parts")
        for c in p.genome.contigs:
            if c.name in names:
                raise ValueError(f"duplicate contig {c.name} across parts")
            names.add(c.name)

    contigs: list[ContigMeta] = []
    codes = []
    offset = 0
    n_mids = len(parts[0].key_mids)
    key_hi, key_lo, pos, nb = [], [], [], []
    key_mids: list[list] = [[] for _ in range(n_mids)]
    for p in parts:
        for c in p.genome.contigs:
            contigs.append(ContigMeta(index=len(contigs), name=c.name,
                                      offset=offset + c.offset,
                                      length=c.length, md5=c.md5))
        codes.append(p.genome.codes)
        key_hi.append(p.key_hi)
        key_lo.append(p.key_lo)
        for i in range(n_mids):
            key_mids[i].append(p.key_mids[i])
        shifted = p.pos.astype(np.int64) + offset
        shifted[p.pos == TOO_MANY_POS] = TOO_MANY_POS
        pos.append(shifted.astype(np.int32))
        nb.append(p.has_neighbors if p.has_neighbors is not None
                  else np.zeros(p.num_records, np.uint8))
        offset += p.genome.total_length

    hi = np.concatenate(key_hi)
    lo = np.concatenate(key_lo)
    mids = [np.concatenate(km) for km in key_mids]
    po = np.concatenate(pos)
    nbits = np.concatenate(nb)
    # keys are bias-encoded: SIGNED comparison is the canonical order
    order = np.lexsort((po, lo, *reversed(mids), hi))
    genome = Genome(codes=np.concatenate(codes), contigs=contigs)
    return SeedIndex(
        seed_len=seed_len,
        repeat_threshold=parts[0].repeat_threshold,
        genome=genome,
        key_hi=hi[order], key_lo=lo[order],
        key_mids=tuple(m[order] for m in mids), pos=po[order],
        total_kmers=sum(p.total_kmers for p in parts),
        collapsed_kmers=sum(p.collapsed_kmers for p in parts),
        has_neighbors=nbits[order] if nbits.any() else None,
    )


def reorder_reference(index: SeedIndex, contig_order: list[str]) -> SeedIndex:
    """Reorder contigs into karyotype order, remapping genome and record
    positions (ReorderReferenceWorkflow)."""
    by_name = {c.name: c for c in index.genome.contigs}
    if sorted(contig_order) != sorted(by_name):
        raise ValueError("contig_order must be a permutation of the contigs")
    contigs: list[ContigMeta] = []
    codes = []
    offset = 0
    # old global position -> new global position, per contig
    shift = np.zeros(len(by_name), np.int64)
    old_off = np.array([c.offset for c in index.genome.contigs], np.int64)
    for i, name in enumerate(contig_order):
        c = by_name[name]
        contigs.append(ContigMeta(index=i, name=name, offset=offset,
                                  length=c.length, md5=c.md5))
        codes.append(index.genome.slice(c.offset, c.length))
        shift[c.index] = offset - c.offset
        offset += c.length
    old_cid = np.searchsorted(old_off, index.pos.astype(np.int64),
                              side="right") - 1
    new_pos = index.pos.astype(np.int64) + shift[np.clip(old_cid, 0, None)]
    new_pos[index.pos == TOO_MANY_POS] = TOO_MANY_POS
    genome = Genome(codes=np.concatenate(codes), contigs=contigs)
    return SeedIndex(
        seed_len=index.seed_len,
        repeat_threshold=index.repeat_threshold,
        genome=genome,
        key_hi=index.key_hi.copy(), key_lo=index.key_lo.copy(),
        key_mids=tuple(m.copy() for m in index.key_mids),
        pos=new_pos.astype(np.int32),
        total_kmers=index.total_kmers,
        collapsed_kmers=index.collapsed_kmers,
        has_neighbors=(index.has_neighbors.copy()
                       if index.has_neighbors is not None else None),
    )


def pack_reference(index_dir: str | Path, out_tgz: str | Path) -> None:
    index_dir = Path(index_dir)
    with tarfile.open(out_tgz, "w:gz") as tf:
        for f in sorted(index_dir.iterdir()):
            tf.add(f, arcname=f.name)


def unpack_reference(tgz: str | Path, out_dir: str | Path) -> None:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    with tarfile.open(tgz, "r:gz") as tf:
        tf.extractall(out, filter="data")
