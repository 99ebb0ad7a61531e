"""SPMD alignment over a [data, shard] mesh of torch devices.

Port of `isaac_aligner_tpu/parallel/sharded.py`.  The JAX package runs one
`shard_map` program over a (data, shard) device mesh; here the same
program runs as eager torch ops, one data row after another, with the
shard collectives written as tensor copies:

- `Mesh` is a [data, shard] array of `torch.device`.  Devices may repeat
  (a mesh of `cuda:0` entries runs every shard on one card, as the JAX
  tests run on virtual CPU devices).
- Data row r runs the unchanged port program (`align_batch`,
  `align_paired_batch`) on its own n/d rows, with its own second-pass and
  rescue capacities, as `shard_map` gives each row.  Results therefore
  equal the JAX mesh run, capacity overflows included.
- Shard collectives, per data row: every shard searches its own index
  planes on its own device (`shard_index` cuts at k-mer boundaries, so a
  k-mer's hit run lives in one shard); the hit lists are concatenated
  along the hit axis in shard order (JAX's tiled `all_gather`), the seed
  diagnostics summed on the row's home device `mesh[r][0]`, and the rest
  of the program (dedup, scoring, MAPQ, trim, clip, rescue) runs once
  there.  JAX replicates that work over `shard`; the result is the same.
- Genome-sharded mode (`GenomeShards`): each shard holds G/S + halo bases
  of the packed planes, and scores, clips and rescues only the rows or
  candidates whose position it owns, against its local slice
  (`plane_base`); the owner-masked results are summed in shard order on
  the home device (every position has one owner, so the sums are exact).
  The port places no whole-genome plane in this mode.
- `collective_dedup` routes records to their anchor's owner device, sorts
  and marks there, and routes the flags home: the two all_to_alls are
  concatenations of the senders' per-destination blocks.

No device tensor leaves a process: the multi-process workflow
(`parallel/multihost.py`) gives each process its own rows and its own
local mesh.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..align.pairs import (TlsStatic, align_paired_batch, mate_window_dynamic,
                           pair_length, pair_model, quantize_rescue_window,
                           rescue_shadows)
from ..align.pipeline import (GN_PAD_WORDS, GP_PAD_WORDS, AlignConfig,
                              IndexArrays, _compact_indices, _score_ungapped,
                              align_batch, build_bucket_table,
                              choose_bucket_width, find_seed_hits,
                              mask_tail_device, packed_genome_planes,
                              semialigned_clip_device)
from ..aligner import RESCUE_CHUNK_ELEMS
from ..index.build import TOO_MANY_POS, SeedIndex
from ..ops import search



class Mesh:
    """A [data, shard] array of torch devices (`shape` as JAX's mesh)."""

    def __init__(self, devices):
        rows = [[torch.device(d) for d in row] for row in devices]
        if not rows or not rows[0] or any(len(r) != len(rows[0])
                                          for r in rows):
            raise ValueError(f"a mesh needs equal non-empty rows: {devices}")
        self.devices = rows
        self.shape = {"data": len(rows), "shard": len(rows[0])}

    def home(self, r: int) -> torch.device:
        """Data row r's home device, where its program runs."""
        return self.devices[r][0]

    @property
    def flat(self) -> list[torch.device]:
        return [d for row in self.devices for d in row]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.devices})"


def make_mesh(n_devices: int | None = None, data: int | None = None,
              shard: int | None = None, device="cuda") -> Mesh:
    """A (data, shard) mesh over n_devices devices: `cuda:k..k+n-1` for
    device "cuda[:k]" (more than the visible cards raises), n entries of
    the CPU for "cpu".  Without data and shard the factorisation favours
    `shard` (index capacity), as the JAX package's does."""
    dev = torch.device(device)
    if dev.type == "cuda":
        first = dev.index or 0
        avail = torch.cuda.device_count() - first
        n = n_devices or avail
        if n < 1 or n > avail:
            raise ValueError(f"{n} devices asked of {device!r}: only "
                             f"{max(avail, 0)} visible")
        devices = [torch.device("cuda", first + i) for i in range(n)]
    else:
        n = n_devices or 1
        devices = [dev] * n
    if data is None and shard is None:
        shard = 1
        while shard * 2 <= n and (n // (shard * 2)) * (shard * 2) == n:
            shard *= 2
        data = n // shard
    elif data is None:
        data = n // shard
    elif shard is None:
        shard = n // data
    if data * shard != n:
        raise ValueError(f"data {data} x shard {shard} != {n} devices")
    return Mesh([devices[r * shard:(r + 1) * shard] for r in range(data)])


# ---------------------------------------------------------------------------
# Index and genome shards
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardedIndexArrays:
    """Host index planes with a leading shard dimension [S, m] (each row
    sorted, padded to a power of two with I32_MAX keys), and the whole
    genome's packed planes and contig bounds, replicated at placement."""

    key_hi: np.ndarray          # int32 [S, m]
    key_lo: np.ndarray          # int32 [S, m]
    pos: np.ndarray             # int32 [S, m], TOO_MANY_POS padding
    n_real: np.ndarray          # int32 [S, 1] real records a shard
    has_neighbors: np.ndarray   # uint8 [S, m]
    bucket_starts: np.ndarray   # int32 [S, 2^width + 1], whole-index width
    genome_packed: np.ndarray   # uint32 (pipeline.pack_genome)
    genome_nbits: np.ndarray    # uint32
    contig_starts: np.ndarray   # int32 [n_contigs]
    contig_ends: np.ndarray     # int32 [n_contigs]
    key_mids: tuple = ()        # 64-mer middle words, int32 [S, m] each


def shard_index(index: SeedIndex, num_shards: int) -> ShardedIndexArrays:
    """Range-shard the sorted index into `num_shards` k-mer-aligned pieces:
    a cut advances while it would split a k-mer run (every key word,
    64-mer middles included), so each k-mer's records live in one shard
    and per-shard repeat counts equal the whole index's."""
    n = index.num_records
    hi, lo, mids = index.key_hi, index.key_lo, index.key_mids
    words = (hi, *mids, lo)
    bounds = [0]
    for s in range(1, num_shards):
        cut = min(n, s * n // num_shards)
        while 0 < cut < n and all(w[cut] == w[cut - 1] for w in words):
            cut += 1
        bounds.append(max(cut, bounds[-1]))
    bounds.append(n)

    m = search.pad_pow2(max(max(bounds[i + 1] - bounds[i]
                                for i in range(num_shards)), 1))
    i32max = np.int32(2**31 - 1)
    key_hi = np.full((num_shards, m), i32max, np.int32)
    key_lo = np.full((num_shards, m), i32max, np.int32)
    key_mids = [np.full((num_shards, m), i32max, np.int32) for _ in mids]
    pos = np.full((num_shards, m), TOO_MANY_POS, np.int32)
    nb = np.zeros((num_shards, m), np.uint8)
    n_real = np.zeros((num_shards, 1), np.int32)
    nb_src = (index.has_neighbors if index.has_neighbors is not None
              else np.zeros(n, np.uint8))
    for s in range(num_shards):
        b, e = bounds[s], bounds[s + 1]
        key_hi[s, :e - b] = hi[b:e]
        key_lo[s, :e - b] = lo[b:e]
        for km, src in zip(key_mids, mids):
            km[s, :e - b] = src[b:e]
        pos[s, :e - b] = index.pos[b:e]
        nb[s, :e - b] = nb_src[b:e]
        n_real[s, 0] = e - b

    width = choose_bucket_width(index.num_records)
    buckets = np.zeros((num_shards, (1 << width) + 1), np.int32)
    for s in range(num_shards):
        buckets[s], _ = build_bucket_table(key_hi[s, :n_real[s, 0]], width)
    packed, nbits = packed_genome_planes(index)
    contigs = index.genome.contigs
    return ShardedIndexArrays(
        key_hi=key_hi, key_lo=key_lo, key_mids=tuple(key_mids), pos=pos,
        has_neighbors=nb, n_real=n_real, bucket_starts=buckets,
        genome_packed=np.asarray(packed), genome_nbits=np.asarray(nbits),
        contig_starts=np.array([c.offset for c in contigs], np.int32),
        contig_ends=np.array([c.end for c in contigs], np.int32))


def _up(x: np.ndarray, dtype, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).astype(dtype)).to(dev)


def _local_index(sharded: ShardedIndexArrays, s: int, dev,
                 genome: bool = True) -> IndexArrays:
    """Shard s's IndexArrays on `dev`: its key planes and bucket table, and
    (with `genome`) the whole genome's packed planes."""
    empty = torch.zeros(0, dtype=torch.int64, device=dev)
    return IndexArrays(
        key_hi=_up(sharded.key_hi[s], np.int32, dev),
        key_lo=_up(sharded.key_lo[s], np.int32, dev),
        key_mids=tuple(_up(km[s], np.int32, dev) for km in sharded.key_mids),
        pos=_up(sharded.pos[s], np.int32, dev),
        n_real=int(sharded.n_real[s, 0]),
        genome=torch.zeros(0, dtype=torch.uint8, device=dev),
        contig_starts=_up(sharded.contig_starts, np.int32, dev),
        contig_ends=_up(sharded.contig_ends, np.int32, dev),
        has_neighbors=_up(sharded.has_neighbors[s], np.uint8, dev),
        genome_packed=(_up(sharded.genome_packed, np.int64, dev) if genome
                       else empty),
        genome_nbits=(_up(sharded.genome_nbits, np.int64, dev) if genome
                      else empty),
        bucket_starts=_up(sharded.bucket_starts[s], np.int32, dev))


def place_sharded(mesh: Mesh, sharded: ShardedIndexArrays,
                  genome: bool = True) -> list[list[IndexArrays]]:
    """Shard s's planes on every device of mesh column s ([data][shard]
    IndexArrays); a device that repeats holds each shard once.  Without
    `genome` no whole-genome plane is placed (genome-sharded mode)."""
    cache: dict = {}
    placed = []
    for row in mesh.devices:
        out = []
        for s, dev in enumerate(row):
            key = (s, str(dev))
            if key not in cache:
                cache[key] = _local_index(sharded, s, dev, genome)
            out.append(cache[key])
        placed.append(out)
    return placed


@dataclasses.dataclass
class GenomeShards:
    """Position-sharded packed genome planes [S, ...] (host numpy): shard
    s owns [base_s, end_s) and holds that range plus a halo, so every
    window that starts in its range reads locally."""

    gp: np.ndarray      # uint32 [S, Wl] local 2-bit slices (+ sentinel pads)
    gn: np.ndarray      # uint32 [S, Wnl] local N-bit slices
    base: np.ndarray    # int32 [S, 1] owned-range start (multiple of 32)
    end: np.ndarray     # int32 [S, 1] owned-range end


GS_HALO = 8_448   # default halo (bases): max_rescue_window + read + slack


def shard_genome_planes(index: SeedIndex, num_shards: int,
                        halo: int = GS_HALO) -> GenomeShards:
    """Slice the packed genome planes into `num_shards` position ranges.
    Shard s's slice covers [base_s - GENOME_PAD, base_s + chunk + halo +
    GENOME_PAD): the halo holds every window that starts in the owned
    range (ungapped windows, semialigned re-scans, the rescue span:
    window + mate length must stay within it)."""
    g = index.genome.total_length
    packed, nbits = packed_genome_planes(index)
    chunk = -(-(-(-g // num_shards)) // 32) * 32
    halo = -(-halo // 32) * 32
    span = chunk + halo
    wl = span // 16 + 2 * GP_PAD_WORDS
    wnl = span // 32 + 2 * GN_PAD_WORDS
    gp = np.zeros((num_shards, wl), np.uint32)
    gn = np.full((num_shards, wnl), 0xFFFFFFFF, np.uint32)   # out of range = N
    base = np.zeros((num_shards, 1), np.int32)
    end = np.zeros((num_shards, 1), np.int32)
    for s in range(num_shards):
        b = s * chunk
        base[s, 0] = b
        end[s, 0] = b + chunk
        # local word 0 is global padded word b // 16 (the global plane
        # carries GP_PAD_WORDS of sentinel at each end)
        src = packed[b // 16:b // 16 + wl]
        gp[s, :len(src)] = src
        nsrc = nbits[b // 32:b // 32 + wnl]
        gn[s, :len(nsrc)] = nsrc
    return GenomeShards(gp=gp, gn=gn, base=base, end=end)


@dataclasses.dataclass
class PlacedGenomeShards:
    """GenomeShards on a mesh: planes[r][s] = (gp, gn) int64 carriers on
    mesh device (r, s); base[s], end[s] the owned ranges."""

    planes: list
    base: list
    end: list


def place_genome_shards(mesh: Mesh, gs: GenomeShards) -> PlacedGenomeShards:
    cache: dict = {}
    planes = []
    for row in mesh.devices:
        out = []
        for s, dev in enumerate(row):
            key = (s, str(dev))
            if key not in cache:
                cache[key] = (_up(gs.gp[s], np.int64, dev),
                              _up(gs.gn[s], np.int64, dev))
            out.append(cache[key])
        planes.append(out)
    return PlacedGenomeShards(planes=planes,
                              base=[int(b) for b in gs.base[:, 0]],
                              end=[int(e) for e in gs.end[:, 0]])


def _gs_local(local: IndexArrays, gp, gn, base: int) -> IndexArrays:
    """A shard's IndexArrays whose packed planes are its local genome
    slice (plane_base set, so every gather indexes locally)."""
    return dataclasses.replace(local, genome_packed=gp, genome_nbits=gn,
                               plane_base=base)


# ---------------------------------------------------------------------------
# Shard collectives
# ---------------------------------------------------------------------------

def _owner_sum(parts, owns, home):
    """Combine per-shard result dicts: each shard's values where it owns
    the row (`owns[s]`), summed in shard order on `home` (bools: any)."""
    out = {}
    for k in parts[0]:
        acc = None
        for part, own in zip(parts, owns):
            v = part[k]
            if v.dtype == torch.bool:
                v = (v & own).to(torch.int32)
            else:
                v = torch.where(own, v, torch.zeros_like(v))
            v = v.to(home)
            acc = v if acc is None else acc + v
        out[k] = acc > 0 if parts[0][k].dtype == torch.bool else acc
    return out


def _gs_hooks(locals_gs: list[IndexArrays], pgs: PlacedGenomeShards,
              g_total: int, home):
    """(score_fn, clip_fn, rescue_fn) of the genome-sharded mode for one
    data row: each shard computes the rows or candidates whose position
    (clipped into [0, G)) it owns, against its local planes, on its own
    device; the owner-masked results sum on `home`."""

    def owns(s, pos):
        pc = torch.clamp(pos, 0, g_total - 1)
        return (pc >= pgs.base[s]) & (pc < pgs.end[s])

    def to(dev, *xs):
        return [x.to(dev) for x in xs]

    def score_fn(_arrays, cfg, bases, quals, cs, co, cv):
        lps, mms, eds, drs = [], [], [], []
        for s, loc in enumerate(locals_gs):
            dev = loc.key_hi.device
            b, q, c_s, c_o, c_v = to(dev, bases, quals, cs, co, cv)
            lp, mm, ed, dropped = _score_ungapped(loc, cfg, b, q, c_s, c_o,
                                                  c_v & owns(s, c_s))
            lps.append(torch.where(torch.isfinite(lp), lp,
                                   torch.zeros_like(lp)).to(home))
            mms.append(mm.to(home))
            eds.append(ed.to(home))
            drs.append(dropped.to(torch.int32).to(home))
        lp_sum = lps[0]
        for x in lps[1:]:
            lp_sum = lp_sum + x
        ninf = torch.full((), float("-inf"), dtype=torch.float32, device=home)
        return (torch.where(cv, lp_sum, ninf), sum(mms[1:], mms[0]),
                sum(eds[1:], eds[0]), sum(drs[1:], drs[0]) > 0)

    def clip_fn(_arrays, cfg, bases, start, rev, aligned, trims):
        parts, own_h = [], []
        for s, loc in enumerate(locals_gs):
            dev = loc.key_hi.device
            b, st, rv, al, tr = to(dev, bases, start, rev, aligned, trims)
            own = owns(s, torch.where(al, st, 0))
            parts.append({k: v for k, v in semialigned_clip_device(
                loc, cfg, b, st, rv, al & own, tr).items()})
            own_h.append(own)
        parts = [{k: v.to(home) for k, v in p.items()} for p in parts]
        return _owner_sum(parts, [o.to(home) for o in own_h], home)

    def rescue_fn(_arrays, cfg, tls, orphan_idx, read_lengths, o_start,
                  o_rev, sb, sq, window):
        parts, own_h = [], []
        for s, loc in enumerate(locals_gs):
            dev = loc.key_hi.device
            st, rv, b, q = to(dev, o_start, o_rev, sb, sq)
            # the owner of the window start (the halo covers the span)
            mn_off, _, _ = mate_window_dynamic(tls, orphan_idx, read_lengths,
                                               rv)
            own = owns(s, st.to(torch.int64) + mn_off)
            out = rescue_shadows(loc, cfg, tls, orphan_idx, read_lengths,
                                 st, rv, b, q, window)
            parts.append({k: v.to(home) for k, v in out.items()})
            own_h.append(own.to(home))
        return _owner_sum(parts, own_h, home)

    return score_fn, clip_fn, rescue_fn


def _gathered_find(locals_row: list[IndexArrays], home):
    """find_fn of one data row: each shard searches its own planes on its
    own device; the hit lists concatenate along the hit axis in shard
    order on `home` and the seed diagnostics sum there.  shard_index cuts
    at k-mer boundaries, so the gathered lists hold exactly the whole
    index's hits (plus padding) and the summed counts are exact."""

    def find_fn(_arrays, cfg, bases):
        parts = [find_seed_hits(loc, cfg, bases.to(loc.key_hi.device))
                 for loc in locals_row]

        def cat(i):
            return torch.cat([p[i].to(home) for p in parts], dim=1)

        diag = dict(parts[0][4])
        for key in ("seed_match_counts", "neighbor_hits"):
            if key in diag:
                diag[key] = sum((p[4][key].to(home) for p in parts[1:]),
                                parts[0][4][key].to(home))
        diag["seed_too_many"] = sum(
            (p[4]["seed_too_many"].to(torch.int32).to(home)
             for p in parts[1:]),
            parts[0][4]["seed_too_many"].to(torch.int32).to(home)) > 0
        return cat(0), cat(1), cat(2), cat(3), diag

    return find_fn


def _split_scalars(res: dict):
    """(batch tensors, scalar tensors) of a result dict: the scalars (seed
    tallies) sum over the data rows, the batch tensors concatenate."""
    batch = {k: v for k, v in res.items() if v.ndim > 0}
    scalars = {k: v for k, v in res.items() if v.ndim == 0}
    return batch, scalars


def _merge_rows(outs: list[dict], home) -> dict:
    """The data rows' results as one batch on `home`: rows in order,
    scalars summed (the JAX program's data-axis psum)."""
    parts = [_split_scalars(o) for o in outs]
    merged = {k: torch.cat([p[0][k].to(home) for p in parts])
              for k in parts[0][0]}
    for k in parts[0][1]:
        merged[k] = sum((p[1][k].to(home) for p in parts[1:]),
                        parts[0][1][k].to(home))
    return merged


def _to_dev(x, dev) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def _row_inputs(mesh: Mesh, r: int, *xs):
    """Data row r's slices of [B, ...] inputs on its home device."""
    d = mesh.shape["data"]
    b = xs[0].shape[0]
    if b % d:
        raise ValueError(f"batch rows ({b}) must divide the mesh data axis "
                         f"({d})")
    per = b // d
    return [_to_dev(x[r * per:(r + 1) * per], mesh.home(r)) for x in xs]


def _check_gs(cfg: AlignConfig, genome_shards) -> None:
    if genome_shards is None:
        return
    if cfg.genome_len <= 0:
        raise ValueError("genome-sharded mode needs cfg.genome_len "
                         "(Aligner.create sets it)")
    idx_k = cfg.index_seed_len or min(cfg.seed_len, 32)
    if cfg.seed_len > idx_k:
        # 64-mer seeds over a 32-mer index check their extension at index
        # positions, which are not position-local; a true 64-mer index
        # needs no extension check and position-shards like any other
        raise ValueError(
            "genome-sharded mode excludes extension-verified long seeds "
            "(64-mer seeds over a 32-mer index); build a 64-mer index "
            "(build_index(seed_len=64)) instead")


def _row_hooks(mesh, placed, genome_shards, cfg, r):
    """(home arrays, find_fn, score_fn, clip_fn, rescue_fn) of row r."""
    home = mesh.home(r)
    locals_row = placed[r]
    find_fn = _gathered_find(locals_row, home)
    if genome_shards is None:
        return locals_row[0], find_fn, None, None, None
    locals_gs = [_gs_local(loc, *genome_shards.planes[r][s],
                           genome_shards.base[s])
                 for s, loc in enumerate(locals_row)]
    score_fn, clip_fn, rescue_fn = _gs_hooks(locals_gs, genome_shards,
                                             cfg.genome_len, home)
    return locals_gs[0], find_fn, score_fn, clip_fn, rescue_fn


# ---------------------------------------------------------------------------
# Single-end programs
# ---------------------------------------------------------------------------

def sharded_align(mesh: Mesh, placed, bases, quals, cfg: AlignConfig) -> dict:
    """The align_batch program over the mesh with per-shard seed search.
    bases/quals [B, L] (numpy or tensors), B divisible by the data axis;
    returns align_batch's dict for all B rows on mesh.home(0)."""
    outs = []
    for r in range(mesh.shape["data"]):
        b, q = _row_inputs(mesh, r, bases, quals)
        arrays, find_fn, *_ = _row_hooks(mesh, placed, None, cfg, r)
        outs.append(align_batch(arrays, b, q, cfg, find_fn=find_fn))
    return _merge_rows(outs, mesh.home(0))


def sharded_align_full(mesh: Mesh, placed, bases, quals, cfg: AlignConfig,
                       tail_masked, lengths,
                       genome_shards: PlacedGenomeShards | None = None
                       ) -> dict:
    """The production single-end SPMD program (consumed by ShardedAligner):
    the adapter re-mask from counts, then the full align_batch (quality
    trim, semialigned clip) per data row.  With `genome_shards` the packed
    planes are position-sharded: scoring and clipping run owner-masked
    per shard and sum.  `lengths` is unused, as in the JAX program."""
    _check_gs(cfg, genome_shards)
    outs = []
    for r in range(mesh.shape["data"]):
        b, q, tm = _row_inputs(mesh, r, bases, quals, tail_masked)
        arrays, find_fn, score_fn, clip_fn, _ = _row_hooks(
            mesh, placed, genome_shards, cfg, r)
        mb, mq = mask_tail_device(b, q, tm)
        outs.append(align_batch(arrays, mb, mq, cfg, tm, find_fn=find_fn,
                                score_fn=score_fn, clip_fn=clip_fn))
    return _merge_rows(outs, mesh.home(0))


# ---------------------------------------------------------------------------
# Paired-end programs (+ in-program shadow rescue)
# ---------------------------------------------------------------------------

def _rescue_inline(local: IndexArrays, cfg: AlignConfig, tls: TlsStatic,
                   res: dict, b1, q1, b2, q2, window: int, rescue_fn=None,
                   rescue_tls: TlsStatic | None = None) -> dict:
    """In-program shadow and disjoined rescue of one data row, merged into
    `res` (the SPMD counterpart of PairedAligner._apply_rescue).

    Only rows that need a rescue (shadow or disjoined) are compacted into
    a block of kcap = min(max(n // 8, 64), n) rows before the window scan;
    results scatter back.  Rows beyond kcap are counted in
    `rescue_dropped` and stay unrescued (a missed optional rescue, never a
    wrong one).  Both directions are computed from the original
    placements; a disjoined row takes the better (summed mismatches, then
    summed log probability, f32) rescued template, orphan 1 on ties."""
    l1, l2 = b1.shape[1], b2.shape[1]
    n = res["aligned_1"].shape[0]
    dev = res["aligned_1"].device
    false = torch.zeros(n, dtype=torch.bool, device=dev)
    disjoined_pre = res.get("disjoined", false)
    kcap = min(max(n // 8, 64), n)
    rtls = rescue_tls if rescue_tls is not None else tls
    scan = rescue_fn or rescue_shadows

    outs = {}
    dropped = torch.zeros((), dtype=torch.int32, device=dev)
    for shadow_end, orphan_end in ((1, 2), (2, 1)):
        sb, sq = (b1, q1) if shadow_end == 1 else (b2, q2)
        need = res[f"shadow_{shadow_end}"] | disjoined_pre
        rows = _compact_indices(need, kcap)
        ok = rows < n
        safe = torch.clamp(rows, max=n - 1)
        dropped = dropped + torch.clamp(
            need.to(torch.int32).sum() - kcap, min=0).to(torch.int32)
        o_start = res[f"start_{orphan_end}"][safe].to(torch.int32)
        o_rev = res[f"reverse_{orphan_end}"][safe]
        # the host rescue's chunk: rows are independent, so chunking the
        # compacted block changes memory only, never the result
        per_call = max(1, RESCUE_CHUNK_ELEMS // (window * sb.shape[1]))
        chunks = [scan(local, cfg, rtls, orphan_end - 1, (l1, l2),
                       o_start[lo:lo + per_call], o_rev[lo:lo + per_call],
                       sb[safe[lo:lo + per_call]], sq[safe[lo:lo + per_call]],
                       window)
                  for lo in range(0, kcap, per_call)]
        out_c = {k: torch.cat([c[k] for c in chunks]) for k in chunks[0]}
        # scatter back to [n] rows; the invalid slots land in a pad row
        dest = torch.where(ok, rows, n)
        out = {}
        for k, v in out_c.items():
            full = torch.zeros((n + 1,) + tuple(v.shape[1:]), dtype=v.dtype,
                               device=dev)
            full[dest] = v
            out[k] = full[:n]
        outs[shadow_end] = out
    for shadow_end in (1, 2):
        res[f"rescued_{shadow_end}"] = false
    res["rescue_dropped"] = res.get(
        "rescue_dropped", torch.zeros((), dtype=torch.int32, device=dev)) \
        + dropped

    # disjoined-template direction choice (buildDisjoinedTemplate,
    # TemplateBuilder.cpp:716-866)
    disjoined = res.get("disjoined", false)
    inf = torch.full((), float("inf"), dtype=torch.float32, device=dev)
    keys = {}
    for orphan_end in (1, 2):
        o = outs[3 - orphan_end]
        key = (res[f"mismatches_{orphan_end}"].to(torch.float32)
               + o["mismatches"].to(torch.float32)) * 1e5 \
            - (res[f"log_prob_{orphan_end}"] + o["log_prob"])
        keys[orphan_end] = torch.where(o["found"], key, inf)
    use2 = keys[2] < keys[1]

    for shadow_end, orphan_end in ((1, 2), (2, 1)):
        out = outs[shadow_end]
        se = f"_{shadow_end}"
        dir_sel = use2 if orphan_end == 2 else ~use2
        hit = out["found"] & (res["shadow" + se] | (disjoined & dir_sel))
        res["rescued" + se] = hit
        res["aligned" + se] = res["aligned" + se] | hit
        for key in ("start", "reverse", "mismatches", "edit_distance",
                    "log_prob"):
            res[key + se] = torch.where(hit, out[key].to(res[key + se].dtype),
                                        res[key + se])
        res["shadow" + se] = res["shadow" + se] & ~hit
        # the rescued pair's score, computed by the rescue in log space
        score = out["score"].to(torch.int32)
        res["frag_score" + se] = torch.where(
            hit, score.to(res["frag_score" + se].dtype), res["frag_score" + se])
        res["template_score"] = torch.where(
            hit, score.to(res["template_score"].dtype), res["template_score"])
        p1, p2 = res["start_1"], res["start_2"]
        r1, r2 = res["reverse_1"], res["reverse_2"]
        model = pair_model(p1, r1, p2, r2)
        length = pair_length(p1, torch.full_like(p1, l1), p2,
                             torch.full_like(p2, l2))
        nominal = ((model == tls.best0) | (model == tls.best1)) & \
            (length >= tls.min) & (length <= tls.max)
        res["pair_resolved"] = res["pair_resolved"] | hit
        res["proper_pair"] = torch.where(hit, nominal, res["proper_pair"])
        res["template_length"] = torch.where(
            hit, length.to(res["template_length"].dtype),
            res["template_length"])
    if "disjoined" in res:
        res["disjoined"] = disjoined & ~res["rescued_1"] & ~res["rescued_2"]
    return res


def _window_of(tls: TlsStatic) -> int:
    return quantize_rescue_window(tls.mate_max - tls.mate_min + 1, 1 << 30)


def sharded_align_paired(mesh: Mesh, placed, b1, q1, b2, q2,
                         cfg: AlignConfig, tls: TlsStatic,
                         rescue: bool = True, window: int | None = None
                         ) -> dict:
    """The align_paired_batch program over the mesh with per-shard seed
    search, plus in-program shadow rescue (`window`: the scan width,
    from the TLS when omitted)."""
    if rescue and window is None:
        window = _window_of(tls)
    outs = []
    for r in range(mesh.shape["data"]):
        a1, c1, a2, c2 = _row_inputs(mesh, r, b1, q1, b2, q2)
        arrays, find_fn, *_ = _row_hooks(mesh, placed, None, cfg, r)
        res = align_paired_batch(arrays, a1, c1, a2, c2, cfg, tls,
                                 find_fn=find_fn)
        if rescue:
            mb1, mq1 = mask_tail_device(a1, c1, res["qtrim_1"])
            mb2, mq2 = mask_tail_device(a2, c2, res["qtrim_2"])
            res = _rescue_inline(arrays, cfg, tls, res, mb1, mq1, mb2, mq2,
                                 window)
        outs.append(res)
    return _merge_rows(outs, mesh.home(0))


def sharded_align_paired_full(mesh: Mesh, placed, b1, q1, b2, q2,
                              cfg: AlignConfig, tls: TlsStatic, tm1, tm2,
                              len1, len2, rescue: bool = True,
                              genome_shards: PlacedGenomeShards | None = None,
                              window: int | None = None,
                              rescue_tls: TlsStatic | None = None) -> dict:
    """The production paired SPMD program (consumed by
    ShardedPairedAligner): the adapter re-mask, the full
    align_paired_batch, in-program rescue on the fully masked reads, and
    a semialigned re-clip of the rescued rows at their new placement.
    `genome_shards` position-shards the packed planes (see
    sharded_align_full); `len1`/`len2` are unused, as in JAX."""
    _check_gs(cfg, genome_shards)
    if rescue and window is None:
        window = _window_of(tls)
    outs = []
    for r in range(mesh.shape["data"]):
        a1, c1, a2, c2, t1, t2 = _row_inputs(mesh, r, b1, q1, b2, q2,
                                             tm1, tm2)
        arrays, find_fn, score_fn, clip_fn, rescue_fn = _row_hooks(
            mesh, placed, genome_shards, cfg, r)
        clip_dev = clip_fn or semialigned_clip_device
        mb1, mq1 = mask_tail_device(a1, c1, t1)
        mb2, mq2 = mask_tail_device(a2, c2, t2)
        res = align_paired_batch(arrays, mb1, mq1, mb2, mq2, cfg, tls, t1, t2,
                                 find_fn=find_fn, score_fn=score_fn,
                                 clip_fn=clip_fn)
        if rescue:
            # the rescue scans fully masked reads (adapter + quality trim),
            # as the host pass does
            rb1, rq1 = mask_tail_device(a1, c1, t1 + res["qtrim_1"])
            rb2, rq2 = mask_tail_device(a2, c2, t2 + res["qtrim_2"])
            res = _rescue_inline(arrays, cfg, tls, res, rb1, rq1, rb2, rq2,
                                 window, rescue_fn=rescue_fn,
                                 rescue_tls=rescue_tls)
            if cfg.semialigned_clip:
                # rescued rows were unaligned when the in-batch clip ran
                for sfx, (bb, qq, tm) in (("_1", (a1, c1, t1)),
                                          ("_2", (a2, c2, t2))):
                    trim = tm + res["qtrim" + sfx]
                    mb, _mq = mask_tail_device(bb, qq, trim)
                    sa = clip_dev(arrays, cfg, mb, res["start" + sfx],
                                  res["reverse" + sfx], res["aligned" + sfx],
                                  trim)
                    hit = res["rescued" + sfx]
                    for k, v in sa.items():
                        res[k + sfx] = torch.where(hit, v, res[k + sfx])
        outs.append(res)
    return _merge_rows(outs, mesh.home(0))


# ---------------------------------------------------------------------------
# Collective duplicate marking
# ---------------------------------------------------------------------------

#: a send slot no row filled: class -1 (invalid), source -1
_DEDUP_FILLS = (0, 0, -1, -1, -1, -1, -1)


def _dedup_send(loc: torch.Tensor, n_dev: int, cap: int):
    """One device's [n_dev, cap, 7] send buffer (its rows slotted by
    owner, in row order) and its overflow count.  `loc` is [n_loc, 6]
    int64: anchor_self, anchor_mate, rank, tie, cls, lib."""
    n_loc = loc.shape[0]
    dev = loc.device
    # owner by a multiplicative hash of the anchor's int32 halves (the
    # JAX package's int32 wrap-around: only the low 31 bits are kept,
    # which the int64 product holds exactly)
    s_hi = loc[:, 0] >> 32
    s_lo = (loc[:, 0] & 0xFFFFFFFF) - 0x80000000
    h = (s_lo * -1640531527) ^ s_hi
    owner = torch.where(loc[:, 4] >= 0, (h & 0x7FFFFFFF) % n_dev, n_dev)
    order = torch.sort(owner, stable=True).indices
    owner_s = owner[order]
    idx = torch.arange(n_loc, dtype=torch.int64, device=dev)
    within = idx - torch.searchsorted(owner_s, owner_s, right=False)
    ok = (owner_s < n_dev) & (within < cap)
    slot = torch.where(ok, owner_s * cap + within, n_dev * cap)
    overflow = ((owner_s < n_dev) & (within >= cap)).sum()
    cols = torch.cat([loc, idx[:, None]], dim=1)[order]
    fills = torch.tensor(_DEDUP_FILLS, dtype=torch.int64, device=dev)
    buf = fills.expand(n_dev * cap + 1, 7).clone()
    buf[slot] = cols
    return buf[:-1].reshape(n_dev, cap, 7), overflow


def _dedup_mark(r: torch.Tensor) -> torch.Tensor:
    """Duplicate flags (int64) of an owner's received [R, 7] rows: sort by
    (valid, cls, lib, anchor_self, anchor_mate) with rank and tie
    descending, by successive stable sorts from the least significant key
    (the JAX package's eleven int32 keys, as seven int64 ones), and mark
    every member of a key run but its first."""
    valid = (r[:, 4] >= 0).to(torch.int64)
    keys = [1 - valid, r[:, 4], r[:, 5], r[:, 0], r[:, 1], ~r[:, 2], ~r[:, 3]]
    perm = torch.arange(r.shape[0], dtype=torch.int64, device=r.device)
    for key in reversed(keys):
        perm = perm[torch.sort(key[perm], stable=True).indices]
    s = r[perm]
    same = torch.zeros(r.shape[0], dtype=torch.bool, device=r.device)
    if r.shape[0] > 1:
        same[1:] = ((s[1:, [0, 1, 4, 5]] == s[:-1, [0, 1, 4, 5]]).all(dim=1)
                    & (s[1:, 4] >= 0) & (s[:-1, 4] >= 0))
    dup = torch.zeros(r.shape[0], dtype=torch.int64, device=r.device)
    dup[perm] = same.to(torch.int64)
    return dup


def collective_dedup(devices, anchor_self, anchor_mate, rank, tie, cls, lib,
                     capacity_factor: float = 4.0):
    """Collective duplicate marking over a list of devices (or a Mesh,
    taken in row order).

    Every record routes to the device owning its anchor (a multiplicative
    hash), owners sort what they received by the duplicate key and mark
    every non-first member, and the flags route home by source index.
    Inputs are host int64 arrays [N], N divisible by the device count.
    Each device's receive capacity per source is max(ceil(cf * n_loc /
    n_dev), min(n_loc, 64)); rows beyond it stay unmarked and are counted.
    Returns (dup flags bool [N], overflow int32 [n_dev]) as numpy."""
    devs = devices.flat if isinstance(devices, Mesh) else [
        torch.device(d) for d in devices]
    n_dev = len(devs)
    table = np.stack([np.asarray(c, np.int64) for c in (
        anchor_self, anchor_mate, rank, tie, cls, lib)], axis=1)
    n = table.shape[0]
    if n % n_dev:
        raise ValueError(f"{n} records do not divide {n_dev} devices")
    n_loc = n // n_dev
    cap = max(int(math.ceil(capacity_factor * n_loc / n_dev)), min(n_loc, 64))
    sends, overflow = [], []
    for d, dev in enumerate(devs):
        buf, ovf = _dedup_send(_to_dev(table[d * n_loc:(d + 1) * n_loc], dev),
                               n_dev, cap)
        sends.append(buf)
        overflow.append(ovf)
    # all_to_all: owner d receives every sender's block d, in sender order
    recv = [torch.cat([sends[s][d].to(devs[d]) for s in range(n_dev)])
            for d in range(n_dev)]
    back = [torch.stack([_dedup_mark(rv), rv[:, 6]], dim=1).reshape(
        n_dev, cap, 2) for rv in recv]
    flags = []
    for d, dev in enumerate(devs):
        b = torch.cat([back[s][d].to(dev) for s in range(n_dev)])
        src = torch.where(b[:, 1] >= 0, b[:, 1], n_loc)
        f = torch.zeros(n_loc + 1, dtype=torch.int64, device=dev)
        f.scatter_reduce_(0, src, b[:, 0], reduce="amax")
        flags.append(f[:-1].cpu().numpy().astype(bool))
    return (np.concatenate(flags),
            np.array([int(o) for o in overflow], np.int32))
