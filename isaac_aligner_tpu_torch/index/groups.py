"""Contig-group index sets: one command for genomes beyond 2^31 bases.

The port's own copy of `isaac_aligner_tpu/index/groups.py`, unchanged but
for the `device` that `build_grouped_indexes` hands to the neighbor
annotation.  A single index addresses < 2^31 bases (int32 position
planes, `index/build.py`); the reference instead widens positions to 40
bits inside a packed u64 (ReferencePosition.hh:55-180).  Whole-genome
scale is expressed as contig GROUPS: greedy, order-preserving partitions
of the contig list, each built as an independent index and aligned
against by `parallel/multi_index.py` with exact cross-group MAPQ merging.

`build_grouped_indexes` writes ``out_dir/group_NN`` per group plus a
``multi-reference.json`` manifest that the align workflow consumes
directly (reference analog: the MergeReferences step that unifies
per-mask metadata into one sorted-reference.xml,
src/c++/lib/workflow/MergeReferencesWorkflow.cpp).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..io.fasta import ContigMeta, Genome
from .build import SeedIndex, build_index, build_index_streaming

MANIFEST = "multi-reference.json"

#: default per-group address-space limit (int32 position planes)
GROUP_LIMIT = 2**31 - 1


def split_genome_groups(contigs, limit: int = GROUP_LIMIT) -> list[list[str]]:
    """Greedy partition of contig names into groups under `limit` bases."""
    groups: list[list[str]] = []
    cur: list[str] = []
    cur_len = 0
    for c in contigs:
        if c.length > limit:
            raise ValueError(f"contig {c.name} alone exceeds {limit} bases")
        if cur and cur_len + c.length > limit:
            groups.append(cur)
            cur, cur_len = [], 0
        cur.append(c.name)
        cur_len += c.length
    if cur:
        groups.append(cur)
    return groups


def subset_genome(genome: Genome, names: list[str]) -> Genome:
    """A new Genome holding only `names` contigs (original order), with
    offsets rebased to the subset's concatenated array."""
    wanted = set(names)
    contigs: list[ContigMeta] = []
    parts: list[np.ndarray] = []
    off = 0
    for c in genome.contigs:
        if c.name not in wanted:
            continue
        parts.append(genome.codes[c.offset : c.end])
        contigs.append(ContigMeta(index=len(contigs), name=c.name,
                                  offset=off, length=c.length, md5=c.md5))
        off += c.length
    if not contigs:
        raise ValueError("no matching contigs for group")
    return Genome(codes=np.concatenate(parts), contigs=contigs)


def build_grouped_indexes(
    genome: Genome,
    out_dir: str | Path,
    limit: int = GROUP_LIMIT,
    seed_len: int = 32,
    repeat_threshold: int = 1000,
    annotate_neighbors: bool = False,
    streaming: bool = False,
    mask_width: int = 6,
    work_dir: str | Path | None = None,
    device="cuda",
) -> list[Path]:
    """Build one index per contig group under `limit` bases; write the
    manifest.  The neighbor annotation runs on `device`.  Returns the
    group directories in genome order."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    groups = split_genome_groups(genome.contigs, limit=limit)
    dirs: list[Path] = []
    for gi, names in enumerate(groups):
        gdir = out / f"group_{gi:02d}"
        sub = subset_genome(genome, names)
        if streaming:
            build_index_streaming(sub, gdir, seed_len=seed_len,
                                  repeat_threshold=repeat_threshold,
                                  annotate_neighbors=annotate_neighbors,
                                  mask_width=mask_width, work_dir=work_dir,
                                  device=device)
        else:
            build_index(sub, seed_len=seed_len,
                        repeat_threshold=repeat_threshold,
                        annotate_neighbors=annotate_neighbors,
                        device=device).save(gdir)
        dirs.append(gdir)
    manifest = {
        "format_version": 1,
        "total_length": genome.total_length,
        "limit": limit,
        "groups": [d.name for d in dirs],
    }
    (out / MANIFEST).write_text(json.dumps(manifest, indent=2))
    return dirs


def is_grouped_reference(path: str | Path) -> bool:
    return (Path(path) / MANIFEST).exists()


def load_grouped_indexes(path: str | Path, mmap: bool = False) -> list[SeedIndex]:
    """Load every group index of a grouped reference dir, manifest order."""
    d = Path(path)
    manifest = json.loads((d / MANIFEST).read_text())
    return [SeedIndex.load(d / g, mmap=mmap) for g in manifest["groups"]]
