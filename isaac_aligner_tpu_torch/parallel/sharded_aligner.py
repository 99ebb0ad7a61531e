"""SPMD aligner drivers: the workflow surface of `parallel/sharded.py`.

Port of `isaac_aligner_tpu/parallel/sharded_aligner.py`.  The subclasses
keep the whole host half of the port's `Aligner` and `PairedAligner`
(adapter masking, fetch, polish, records) and swap only the device
program: `_dispatch` runs the sharded program (per-shard seed search,
gathered hit lists, scoring on each data row's home device, in-program
shadow rescue) over a [data, shard] mesh.  The program is the same
align_batch / align_paired_batch code reached through the hooks, so the
results equal the single-device drivers' (k-mer-aligned index shards give
the same hit lists) wherever the per-row capacities do not overflow.

The index planes live only on the mesh: the drivers hold no whole-index
copy (`arrays` stays None).  The host polish (banded SW on the card) runs
on the mesh's first device.  The JAX drivers' result packing for the TPU
link (`pack_device_result`, `compact_cand_result`) is left behind.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..align import clippers
from ..align.pipeline import score_end
from ..aligner import Aligner, PairedAligner, _pad_to_seed, _upload
from ..io.fastq import ReadBatch
from ..utils import tracing
from .sharded import (GS_HALO, Mesh, PlacedGenomeShards, _row_hooks,
                      make_mesh, place_genome_shards, place_sharded,
                      shard_genome_planes, shard_index, sharded_align_full,
                      sharded_align_paired_full)


def _base_kwargs(base) -> dict:
    return {f.name: getattr(base, f.name) for f in dataclasses.fields(base)}


def _check_rows(n: int, mesh: Mesh) -> None:
    d = mesh.shape["data"]
    if n % d:
        raise ValueError(
            f"batch rows ({n}) must divide the mesh data axis ({d}); "
            f"pick a batch_size that is a multiple of {d}")


def _place(index, mesh: Mesh, genome_sharded: bool):
    """(placed index shards, placed genome shards or None) on the mesh."""
    s = mesh.shape["shard"]
    placed = place_sharded(mesh, shard_index(index, s),
                           genome=not genome_sharded)
    gs = (place_genome_shards(mesh, shard_genome_planes(index, s))
          if genome_sharded else None)
    return placed, gs


def _create(cls, base_cls, index, mesh, n_devices, read_len, cfg,
            genome_sharded, device, opts):
    mesh = mesh or make_mesh(n_devices, device=device)
    base = base_cls.create(index, read_len=read_len, cfg=cfg,
                           device=mesh.home(0), defer_upload=True, **opts)
    placed, gs = _place(index, mesh, genome_sharded)
    return cls(**_base_kwargs(base), mesh=mesh, placed=placed,
               genome_shards=gs)


def _orig_and_masked(batch: ReadBatch, adapters, seed_len: int):
    """(adapter-masked host copies, original padded bases/quals, trims)."""
    bases = batch.bases.copy()
    quals = batch.quals.copy()
    trims = clippers.adapter_trim_batch(bases, quals, list(adapters))
    bases, quals = _pad_to_seed(bases, quals, seed_len)
    ob, oq = _pad_to_seed(batch.bases, batch.quals, seed_len)
    return (bases, quals), (ob, oq), trims


@dataclasses.dataclass
class ShardedAligner(Aligner):
    """Single-end SPMD driver: Aligner's host passes over the sharded
    program."""

    mesh: Mesh = None
    placed: list = None
    genome_shards: PlacedGenomeShards | None = None

    @staticmethod
    def create_sharded(index, mesh: Mesh | None = None,
                       n_devices: int | None = None,
                       read_len: int | None = None, cfg=None,
                       genome_sharded: bool = False, device="cuda",
                       **opts) -> "ShardedAligner":
        """The driver over `mesh` (or make_mesh(n_devices, device=...))."""
        return _create(ShardedAligner, Aligner, index, mesh, n_devices,
                       read_len, cfg, genome_sharded, device, opts)

    def ensure_uploaded(self) -> None:
        """The planes were placed on the mesh at create."""

    def _dispatch(self, batch: ReadBatch):
        with tracing.collect(self.timings), tracing.span("dispatch"):
            _check_rows(batch.bases.shape[0], self.mesh)
            (bases, quals), (ob, oq), trims = _orig_and_masked(
                batch, self.adapters, self.cfg.seed_len)
            out = sharded_align_full(self.mesh, self.placed, ob, oq,
                                     self.cfg, trims.astype(np.int32),
                                     batch.lengths.astype(np.int32),
                                     genome_shards=self.genome_shards)
            return out, bases, quals, trims, batch


@dataclasses.dataclass
class ShardedPairedAligner(PairedAligner):
    """Paired SPMD driver with in-program shadow rescue: the host rescue
    pass is a no-op (the program scanned the TLS window of every shadow
    and disjoined row and re-clipped the rescued placements)."""

    mesh: Mesh = None
    placed: list = None
    genome_shards: PlacedGenomeShards | None = None

    @staticmethod
    def create_sharded(index, mesh: Mesh | None = None,
                       n_devices: int | None = None,
                       read_len: int | None = None, cfg=None,
                       genome_sharded: bool = False, device="cuda",
                       **opts) -> "ShardedPairedAligner":
        """The driver over `mesh` (or make_mesh(n_devices, device=...))."""
        return _create(ShardedPairedAligner, PairedAligner, index, mesh,
                       n_devices, read_len, cfg, genome_sharded, device, opts)

    def ensure_uploaded(self) -> None:
        """The planes were placed on the mesh at create."""

    def _score_end(self, batch: ReadBatch) -> dict:
        """TLS learning through data row 0's sharded search and scorer."""
        arrays, find_fn, score_fn, _clip, _resc = _row_hooks(
            self.mesh, self.placed, self.genome_shards, self.cfg, 0)
        home = self.mesh.home(0)
        return score_end(arrays, self.cfg, _upload(batch.bases, home),
                         _upload(batch.quals, home), find_fn, score_fn)

    def _rescue_key(self, tls=None) -> tuple[int, bool]:
        """(scan window, rescue on): the rescue runs when the quantized
        TLS window fits max_rescue_window."""
        window = self._rescue_window(tls)
        rescue = window <= self.max_rescue_window
        if rescue and self.genome_shards is not None \
                and window + 512 > GS_HALO:
            raise ValueError(f"rescue window {window} + 512 exceeds the "
                             f"genome shards' halo {GS_HALO}")
        return (window if rescue else 0), rescue

    def _dispatch(self, b1: ReadBatch, b2: ReadBatch):
        with tracing.collect(self.timings), tracing.span("dispatch"):
            _check_rows(b1.bases.shape[0], self.mesh)
            btls = self._batch_tls(b1)
            window, rescue = self._rescue_key(btls)
            masked, orig, trims = [], [], []
            for b in (b1, b2):
                (bases, quals), o, t = _orig_and_masked(b, self.adapters,
                                                        self.cfg.seed_len)
                masked.append(ReadBatch(b.names, bases, quals, b.lengths))
                orig.append(o)
                trims.append(t)
            if getattr(b1, "tls_hint", None) is not None:
                # the masked copy reaches _apply_rescue: with the batch's
                # model its skip count follows the program's rescue
                masked[0].tls_hint = b1.tls_hint
            out = sharded_align_paired_full(
                self.mesh, self.placed, orig[0][0], orig[0][1], orig[1][0],
                orig[1][1], self.cfg, btls, trims[0].astype(np.int32),
                trims[1].astype(np.int32), b1.lengths.astype(np.int32),
                b2.lengths.astype(np.int32), rescue=rescue,
                genome_shards=self.genome_shards, window=window,
                rescue_tls=self._rescue_tls(btls))
            return out, masked[0], masked[1], trims, (b1, b2)

    def _apply_rescue(self, res, b1: ReadBatch, b2: ReadBatch):
        """The rescue ran in the program; when the TLS window was over
        max_rescue_window it was skipped there too, and the stranded rows
        are counted as the host path counts them."""
        n = res["aligned_1"].shape[0]
        if not self._rescue_key(self._batch_tls(b1))[1]:
            dis = res.get("disjoined")
            res["rescue_skipped_count"] = int(
                res["shadow_1"].sum() + res["shadow_2"].sum()
                + (dis.sum() if dis is not None else 0))
        return np.zeros(n, bool), np.zeros(n, bool)
