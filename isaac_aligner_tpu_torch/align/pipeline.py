"""The device pipeline on torch tensors (single-end, and each end of a pair).

Port of `isaac_aligner_tpu/align/pipeline.py` (the JAX program that
`_single_packed_jit` compiles into one XLA executable).  Here the same
stages run as eager torch ops on the aligner's device:

    quality trim -> seed packing -> bucketed binary search -> two-pass seed
    escalation -> sort-dedup -> packed-word ungapped scoring -> best pick ->
    MAPQ -> semialigned-end clip

Every shape stays fixed as in JAX (capacity-bounded hits, candidates and
scoring queue), so no stage syncs with the host: `jnp.nonzero(size=...)`
becomes a cumsum + scatter compaction, `.at[].set(mode="drop")` a write to
a scratch row, and every gather index is clamped in range.  uint32 words
ride in int64 carriers so shifts are logical.

The paired path (`align/pairs.py`) scores each end with `score_end`: the
same stages up to the ungapped scorer, without the single-end pick.

Not ported yet (they raise NotImplementedError rather than run a different
path): 64-mer seeds and 64-mer indexes, neighbor (Hamming<=1) matching,
and --scatter-repeats (ROADMAP queue A).  The result packing for the TPU
link (`compact_cand_result`, `pack_device_result`) is left behind.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import dna
from ..device import require_device
from ..index.build import TOO_MANY_POS, SeedIndex, unbias_i32_to_u32
from ..ops import bitops, search
from . import quality
from .clippers import CONSECUTIVE_MATCHES_MIN, MASK_READ_LENGTH_MIN

BUCKET_WIDTH = 16

# head/tail padding of the packed genome planes, in WORDS: 256 bases of
# out-of-genome sentinel each side so candidates overhanging a contig (or
# the genome) edge still gather aligned windows
GP_PAD_WORDS = 16     # 2-bit plane: 16 bases/word -> 256 bases
GN_PAD_WORDS = 8      # N-bit plane: 32 bases/word -> 256 bases
GENOME_PAD = GP_PAD_WORDS * 16

_U32 = bitops.U32_MASK
_I32_MAX = 2**31 - 1

_ROADMAP_ITEM = "ROADMAP queue A: 64-mer seeds and neighbor matching"
_NOT_PORTED_64 = f"64-mer seeds / 64-mer indexes are not ported yet ({_ROADMAP_ITEM})"
_NOT_PORTED_NB = (f"neighbor matching (neighborhood_size_threshold > 0) is not "
                  f"ported yet ({_ROADMAP_ITEM})")
_NOT_PORTED_SCATTER = f"scatter_repeats is not ported yet ({_ROADMAP_ITEM})"


@dataclasses.dataclass
class IndexArrays:
    """Device-resident index planes (counterpart of the JAX IndexArrays)."""

    key_hi: torch.Tensor          # int32 [Npad] sorted, biased; I32_MAX padding
    key_lo: torch.Tensor          # int32 [Npad]
    pos: torch.Tensor             # int32 [Npad] global positions / TOO_MANY_POS
    n_real: int                   # number of real records
    genome: torch.Tensor          # uint8 [G] base codes (or [0] when not uploaded)
    contig_starts: torch.Tensor   # int32 [n_contigs] sorted
    contig_ends: torch.Tensor     # int32 [n_contigs]
    has_neighbors: torch.Tensor   # uint8 [Npad]
    # packed genome planes, uint32 words in int64 carriers: 16 bases per
    # word (big-endian lanes) and 32 N-bits per word, sentinel-padded
    genome_packed: torch.Tensor   # int64 [ceil(G/16) + 2*GP_PAD_WORDS]
    genome_nbits: torch.Tensor    # int64 [ceil(G/32) + 2*GN_PAD_WORDS]
    bucket_starts: torch.Tensor   # int32 [2^bucket_width + 1]
    plane_base: int = 0
    key_mids: tuple = ()


@dataclasses.dataclass(frozen=True)
class AlignConfig:
    """Static alignment parameters; same fields and defaults as the JAX
    AlignConfig (see its comments for the reference semantics)."""

    seed_len: int = 32
    seed_offsets: tuple[int, ...] = (0, 32)
    index_seed_len: int | None = None
    max_hits_per_seed: int = 10
    repeat_threshold: int = 10
    max_candidates: int = 32
    max_scored_candidates: int = 16
    scored_pairs_per_read: int = 3
    first_pass_seeds: int = 1
    second_pass_fraction: float = 0.25
    mapq_cap: int = 60
    rescue_max_mismatch_frac: float = 0.25
    neighborhood_size_threshold: int = 0
    neighbor_scan_cap: int = 32
    bucket_log2: int | None = None
    bucket_width: int = BUCKET_WIDTH
    dodgy_mapq: int = 0
    dodgy_unaligned: bool = False
    ignore_neighbors: bool = False
    ignore_repeats: bool = False
    scatter_repeats: bool = False
    quality_trim_cutoff: int = 0
    semialigned_clip: bool = False
    genome_has_n: bool = True
    genome_len: int = 0


def genome_len_of(arrays: IndexArrays, cfg: AlignConfig) -> int:
    """Static genome length: cfg.genome_len when set, else the raw codes
    plane's length."""
    return cfg.genome_len or int(arrays.genome.shape[0])


# ---------------------------------------------------------------------------
# Host helpers (numpy; same as the JAX package's)
# ---------------------------------------------------------------------------

def pack_genome(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pack base codes into 2-bit words + an N-bit plane (host, numpy).

    Word w holds bases [16w, 16w+16) big-endian; N packs as code 0 with
    its bit set in the 1-bit-per-base plane (base 32w in bit 31).
    GENOME_PAD bases of out-of-genome sentinel (N-bit set) pad both ends.
    """
    g = codes.shape[0]
    n16 = -(-g // 16)
    padded = np.zeros(n16 * 16, np.uint32)
    clean = np.where(codes < 4, codes, 0).astype(np.uint32)
    padded[:g] = clean
    lanes = padded.reshape(n16, 16)
    shifts = (2 * (15 - np.arange(16))).astype(np.uint32)
    packed = (lanes << shifts[None, :]).astype(np.uint32).sum(axis=1, dtype=np.uint32)
    zpad = np.zeros(GP_PAD_WORDS, np.uint32)
    packed = np.concatenate([zpad, packed, zpad])

    n32 = -(-g // 32)
    nb = np.zeros(n32 * 32, np.uint32)
    nb[:g] = (codes >= 4).astype(np.uint32)
    nb[g:] = 1
    nlanes = nb.reshape(n32, 32)
    nshifts = (31 - np.arange(32)).astype(np.uint32)
    nbits = (nlanes << nshifts[None, :]).astype(np.uint32).sum(axis=1, dtype=np.uint32)
    npad = np.full(GN_PAD_WORDS, 0xFFFFFFFF, np.uint32)
    nbits = np.concatenate([npad, nbits, npad])
    return packed, nbits


def choose_bucket_width(n_records: int) -> int:
    """Bucket-table width scaling with index size (~64 records/bucket)."""
    if n_records <= 1:
        return BUCKET_WIDTH
    return min(20, max(BUCKET_WIDTH, int(math.log2(n_records / 64))))


def build_bucket_table(key_hi_i32: np.ndarray,
                       width: int = BUCKET_WIDTH) -> tuple[np.ndarray, int]:
    """(bucket_starts int32 [2^width + 1], bucket_log2): bucket_starts[m]
    is the first record whose top `width` key bits are >= m, and
    2^bucket_log2 bounds the largest bucket."""
    qu = unbias_i32_to_u32(np.asarray(key_hi_i32, np.int32))
    n = len(qu)
    thresholds = (np.arange(1, 1 << width, dtype=np.uint64)
                  << (32 - width)).astype(np.uint32)
    edges = np.searchsorted(qu, thresholds, side="left")
    starts = np.concatenate([[0], edges, [n]]).astype(np.int32)
    max_bucket = int(np.diff(starts).max()) if n else 1
    log2 = 0
    while (1 << log2) < max(max_bucket, 1):
        log2 += 1
    return starts, max(log2, 1)


def _cached_bucket_table(index: SeedIndex) -> tuple[np.ndarray, int, int]:
    """(starts, width, log2) for the index, memoized on the instance (the
    same attribute and contents as the JAX package's memo)."""
    width = choose_bucket_width(index.num_records)
    cached = getattr(index, "_bucket_table", None)
    if cached is None or cached[1] != width:
        starts, log2 = build_bucket_table(index.key_hi, width)
        cached = (starts, width, log2)
        index._bucket_table = cached
    return cached


def bucket_params_for(index: SeedIndex) -> tuple[int, int]:
    """(bucket_width, bucket_log2) matching prepare_index's table."""
    _starts, width, log2 = _cached_bucket_table(index)
    return width, log2


def genome_has_n_for(index: SeedIndex) -> bool:
    """Whether the genome contains any ambiguous base (cached)."""
    cached = getattr(index, "_has_n", None)
    if cached is None:
        cached = bool((index.genome.codes >= 4).any())
        index._has_n = cached
    return cached


def default_seed_offsets(read_len: int, seed_len: int) -> tuple[int, ...]:
    """Seeds tiling the read plus one flush with the read end."""
    n = max(1, read_len // seed_len)
    offsets = [i * seed_len for i in range(n)]
    tail = read_len - seed_len
    if tail > offsets[-1]:
        offsets.append(tail)
    return tuple(offsets)


def seed_table(read_len: int, cfg: AlignConfig) -> list[tuple[int, int]]:
    """Static (orient, query-offset) seed list; orient-1 seeds live at the
    mirrored offset in the reverse-complemented read."""
    k = cfg.seed_len
    seed_list: list[tuple[int, int]] = []
    for off in cfg.seed_offsets:
        if off + k > read_len:
            continue
        seed_list.append((0, off))
        seed_list.append((1, read_len - off - k))
    if not seed_list:
        raise ValueError(f"no seed fits read_len={read_len} seed_len={k}")
    return seed_list


# ---------------------------------------------------------------------------
# Index upload
# ---------------------------------------------------------------------------

def prepare_index(index: SeedIndex, device,
                  upload_codes: bool = False) -> IndexArrays:
    """Upload a host SeedIndex into padded planes on `device`.

    upload_codes=False skips the raw uint8 codes plane: every device
    consumer reads the packed planes, and cfg.genome_len (set by
    Aligner.create) carries the genome length."""
    dev = require_device(device)
    if index.key_mids:
        raise NotImplementedError(_NOT_PORTED_64)
    n = index.num_records
    n_pad = search.pad_pow2(max(n, 1))
    pad = n_pad - n
    key_hi = np.concatenate([index.key_hi, np.full(pad, _I32_MAX, np.int32)])
    key_lo = np.concatenate([index.key_lo, np.full(pad, _I32_MAX, np.int32)])
    pos = np.concatenate([index.pos, np.full(pad, TOO_MANY_POS, np.int32)])
    nb = (index.has_neighbors if index.has_neighbors is not None
          else np.zeros(n, np.uint8))
    nb = np.concatenate([nb.astype(np.uint8), np.zeros(pad, np.uint8)])
    cached_planes = getattr(index, "_packed_planes", None)
    if cached_planes is not None:
        packed, nbits = cached_planes   # mmapped, saved by SeedIndex.save
    else:
        packed, nbits = pack_genome(index.genome.codes)
    bucket_starts, _width, _log2 = _cached_bucket_table(index)
    contigs = index.genome.contigs

    def up(x, dtype):
        return torch.from_numpy(np.array(x, dtype=dtype)).to(dev)

    return IndexArrays(
        key_hi=up(key_hi, np.int32),
        key_lo=up(key_lo, np.int32),
        pos=up(pos, np.int32),
        n_real=n,
        genome=(up(index.genome.codes, np.uint8) if upload_codes
                else torch.zeros(0, dtype=torch.uint8, device=dev)),
        contig_starts=up([c.offset for c in contigs], np.int32),
        contig_ends=up([c.end for c in contigs], np.int32),
        has_neighbors=up(nb, np.uint8),
        genome_packed=up(packed, np.int64),
        genome_nbits=up(nbits, np.int64),
        bucket_starts=up(bucket_starts, np.int32),
    )


def index_arrays_from_numpy(d: dict, device) -> IndexArrays:
    """Build the port's IndexArrays from the JAX package's IndexArrays
    pulled to numpy (`{name: np.asarray(plane)}`), so both sides read
    identical planes."""
    dev = require_device(device)
    if d.get("key_mids"):
        raise NotImplementedError(_NOT_PORTED_64)

    def up(name, dtype):
        return torch.from_numpy(np.array(d[name], dtype=dtype)).to(dev)

    return IndexArrays(
        key_hi=up("key_hi", np.int32),
        key_lo=up("key_lo", np.int32),
        pos=up("pos", np.int32),
        n_real=int(d["n_real"]),
        genome=up("genome", np.uint8),
        contig_starts=up("contig_starts", np.int32),
        contig_ends=up("contig_ends", np.int32),
        has_neighbors=up("has_neighbors", np.uint8),
        genome_packed=up("genome_packed", np.int64),
        genome_nbits=up("genome_nbits", np.int64),
        bucket_starts=up("bucket_starts", np.int32),
        plane_base=int(d.get("plane_base", 0)),
    )


def pack_reads(bases: torch.Tensor) -> torch.Tensor:
    """Pack [B, L] read codes into [B, ceil(L/16)] big-endian uint32 words
    (int64 carriers; N and tail padding pack as 0)."""
    b, l = bases.shape
    w = -(-l // 16)
    x = bases.to(torch.int64)
    x = torch.where(x < 4, x, 0)
    if w * 16 != l:
        x = torch.nn.functional.pad(x, (0, w * 16 - l))
    shifts = 2 * (15 - torch.arange(16, dtype=torch.int64, device=bases.device))
    # lanes never overlap, so the sum is the bitwise or
    return (x.reshape(b, w, 16) << shifts).sum(dim=2)


def sum_f32(terms: torch.Tensor) -> torch.Tensor:
    """Sum float32 terms over the last axis in float64 and round once to
    float32.  The card's and the CPU's reduction orders then give the same
    float32 value, and alignments whose per-base terms are the same
    multiset (two repeat copies with the same mismatch qualities) tie
    exactly, so the first-index argmin picks the same candidate on every
    device."""
    return terms.to(torch.float64).sum(dim=-1).to(torch.float32)


def _compact_indices(mask: torch.Tensor, size: int) -> torch.Tensor:
    """Indices of the first `size` true entries of a 1-D mask, in order,
    padded with len(mask): `jnp.nonzero(mask, size=size,
    fill_value=len(mask))` without a device-to-host sync."""
    n = mask.shape[0]
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    slot = torch.where(mask & (rank < size), rank, size)   # slot `size` = scratch
    out = torch.full((size + 1,), n, dtype=torch.int64, device=mask.device)
    out.scatter_(0, slot, torch.arange(n, dtype=torch.int64, device=mask.device))
    return out[:size]


def _contig_of(arrays: IndexArrays, mid: torch.Tensor) -> torch.Tensor:
    """Contig id owning each position (searchsorted side="right" - 1)."""
    cid = torch.searchsorted(arrays.contig_starts, mid.contiguous(), right=True) - 1
    return torch.clamp(cid, 0, arrays.contig_starts.shape[0] - 1)


def _funnel(words: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Logical funnel shift of adjacent uint32 words (int64 carriers):
    (lo << s) | (hi >> (32 - s)), 0 <= s < 32 (s == 0 gives lo)."""
    return ((words[:, :-1] << shift) & _U32) | (words[:, 1:] >> (32 - shift))


def _mismatch_planes(arrays: IndexArrays, cfg: AlignConfig, start, read_words,
                     read_len: int):
    """(code_mismatch, ref_n) [P, L] of reads placed at `start`: gather
    ceil(L/16)+1 packed genome words, funnel-shift into read phase, XOR
    with the packed read and expand the 2-bit lanes; likewise the N-bit
    plane when the genome has Ns."""
    p = start.shape[0]
    dev = start.device
    w_read = -(-read_len // 16)
    start64 = start.to(torch.int64)
    gp = arrays.genome_packed
    word0 = ((start64 - arrays.plane_base) >> 4) + GP_PAD_WORDS
    t_idx = torch.arange(w_read + 1, dtype=torch.int64, device=dev)
    words = gp[torch.clamp(word0[:, None] + t_idx, 0, gp.shape[0] - 1)]
    aligned = _funnel(words, ((start64 & 15) << 1)[:, None])
    x = aligned ^ read_words
    lane_shifts = 2 * (15 - torch.arange(16, dtype=torch.int64, device=dev))
    lanes = (x[:, :, None] >> lane_shifts) & 3
    code_mismatch = (lanes != 0).reshape(p, w_read * 16)[:, :read_len]

    if not cfg.genome_has_n:
        return code_mismatch, torch.zeros((p, read_len), dtype=torch.bool,
                                          device=dev)
    gn = arrays.genome_nbits
    w_n = -(-(read_len + 31) // 32) + 1
    nword0 = ((start64 - arrays.plane_base) >> 5) + GN_PAD_WORDS
    nt = torch.arange(w_n, dtype=torch.int64, device=dev)
    nwords = gn[torch.clamp(nword0[:, None] + nt, 0, gn.shape[0] - 1)]
    naligned = _funnel(nwords, (start64 & 31)[:, None])
    nlane_shifts = 31 - torch.arange(32, dtype=torch.int64, device=dev)
    nlanes = (naligned[:, :, None] >> nlane_shifts) & 1
    ref_n = (nlanes != 0).reshape(p, (w_n - 1) * 32)[:, :read_len]
    return code_mismatch, ref_n


def _finder_stats_from_diag(diag: dict) -> dict:
    """MatchFinderStats analog: per-batch seed outcome tallies."""
    finder = {}
    if "seed_match_counts" in diag:
        finder["seeds_no_match"] = (diag["seed_match_counts"] == 0).sum().to(torch.int32)
        finder["seeds_too_many"] = diag["seed_too_many"].sum().to(torch.int32)
    for key in ("pass2_reads", "pass2_dropped"):
        if key in diag:
            finder[key] = diag[key]
    return finder


# ---------------------------------------------------------------------------
# Stages
# ---------------------------------------------------------------------------

def find_seed_hits(arrays: IndexArrays, cfg: AlignConfig, bases: torch.Tensor):
    """Stage A: exact 16/32-mer seeds -> per-hit (start, orient, valid,
    clean), flat [B, S*R], plus per-seed diagnostics."""
    b, read_len = bases.shape
    k = cfg.seed_len
    idx_k = cfg.index_seed_len or min(k, 32)
    if k == 64 or idx_k == 64 or arrays.key_mids:
        raise NotImplementedError(_NOT_PORTED_64)
    if cfg.neighborhood_size_threshold > 0:
        raise NotImplementedError(_NOT_PORTED_NB)
    dev = bases.device
    rc_bases = bitops.revcomp_reads(bases)
    seed_list = seed_table(read_len, cfg)

    his, los, nmask = [], [], []
    for orient, qoff in seed_list:
        hi, lo, has_n = bitops.pack_seed(bases if orient == 0 else rc_bases,
                                         qoff, k)
        his.append(hi)
        los.append(lo)
        nmask.append(has_n)
    q_hi = torch.stack(his, dim=1)                    # [B, S]
    q_lo = torch.stack(los, dim=1)
    seed_has_n = torch.stack(nmask, dim=1)
    qoff_arr = torch.tensor([s[1] for s in seed_list], dtype=torch.int32,
                            device=dev)
    orient_arr = torch.tensor([s[0] for s in seed_list], dtype=torch.int32,
                              device=dev)

    if cfg.bucket_log2 is not None:
        # the count only needs resolving up to "more than repeat_threshold"
        need = max(cfg.repeat_threshold, cfg.max_hits_per_seed) + 1
        cap_log2 = 0
        while (1 << cap_log2) < need:
            cap_log2 += 1
        begin, count = search.sorted_range_bucketed(
            arrays.key_hi, arrays.key_lo, q_hi, q_lo, arrays.n_real,
            arrays.bucket_starts, cfg.bucket_width, cfg.bucket_log2,
            count_cap_log2=cap_log2)
    else:
        begin, count = search.sorted_range(arrays.key_hi, arrays.key_lo,
                                           q_hi, q_lo, arrays.n_real)
    count = torch.where(seed_has_n, 0, count)

    last = arrays.key_hi.shape[0] - 1
    begin64 = begin.to(torch.int64)
    first_pos = arrays.pos[torch.clamp(begin64, max=last)]
    too_many = (count > cfg.repeat_threshold) | \
        ((count > 0) & (first_pos == int(TOO_MANY_POS)))
    eff = torch.where(too_many, 0, torch.clamp(count, max=cfg.max_hits_per_seed))

    r = torch.arange(cfg.max_hits_per_seed, dtype=torch.int64, device=dev)
    hit_idx = torch.clamp(begin64[:, :, None] + r, max=last)      # [B, S, R]
    hit_valid = r < eff[:, :, None]
    hit_pos = arrays.pos[hit_idx]

    start = hit_pos - qoff_arr[None, :, None]
    orient = orient_arr[None, :, None].expand(start.shape)
    # a hit from a k-mer without genomic neighbors is a clean anchor
    hit_nb = arrays.has_neighbors[hit_idx]
    clean = hit_valid if cfg.ignore_neighbors else hit_valid & (hit_nb == 0)

    # candidates may overhang a contig edge by up to max_over bases; at
    # least read_len//2 + 1 bases stay inside so the middle base locates
    # the owning contig
    min_inside = read_len // 2 + 1
    max_over = min(read_len - min_inside, GENOME_PAD - 1)
    mid = start + read_len // 2
    cid = _contig_of(arrays, mid)
    cs = arrays.contig_starts[cid]
    ce = arrays.contig_ends[cid]
    in_bounds = (mid >= cs) & (mid < ce) & (start >= cs - max_over) & \
        (start + read_len <= ce + max_over)
    valid = hit_valid & in_bounds & (start >= -max_over)

    diag = {"seed_match_counts": count, "seed_too_many": too_many}
    return (start.reshape(b, -1), orient.reshape(b, -1),
            valid.reshape(b, -1), clean.reshape(b, -1), diag)


def dedup_candidates(start_f, orient_f, valid_f, clean_f, max_candidates: int):
    """Stage B: sort-dedup hit lists, compact to [B, C].

    One stable sort on a packed int64 key orders the hits exactly like
    the JAX 4-key lexicographic sort (invalid, orient, start, not_clean):
    start + 2^31 takes bits 1..32 (starts may be negative).  Within an
    (orient, start) run clean hits sort first, so the kept representative
    is clean iff any supporting hit was; the run length is the support.
    """
    b, h = start_f.shape
    dev = start_f.device
    invalid = (~valid_f).to(torch.int64)
    not_clean = (~clean_f).to(torch.int64)
    key = (invalid << 34) | (orient_f.to(torch.int64) << 33) | \
        ((start_f.to(torch.int64) + (1 << 31)) << 1) | not_clean
    order = torch.sort(key, dim=1, stable=True).indices
    invalid_s = invalid.gather(1, order)
    orient_s = orient_f.gather(1, order)
    start_s = start_f.gather(1, order)
    not_clean_s = not_clean.gather(1, order)
    same_as_prev = torch.zeros((b, h), dtype=torch.bool, device=dev)
    same_as_prev[:, 1:] = (orient_s[:, 1:] == orient_s[:, :-1]) & \
        (start_s[:, 1:] == start_s[:, :-1])
    unique = (invalid_s == 0) & ~same_as_prev
    # per-run support: distance from each run head to the next run head
    # (or to the end of the valid region), via a suffix cumulative min
    big = _I32_MAX
    slot = torch.arange(h, dtype=torch.int64, device=dev).expand(b, h)
    head_slots = torch.where(unique, slot, big)
    nxt_incl = torch.cummin(head_slots.flip(1), dim=1).values.flip(1)
    nxt = torch.full((b, h), big, dtype=torch.int64, device=dev)
    nxt[:, :-1] = nxt_incl[:, 1:]
    n_valid = valid_f.sum(dim=1, keepdim=True)
    support_s = torch.clamp(torch.minimum(nxt, n_valid) - slot, 0, 10_000)

    # stable-compact unique entries to the front
    corder = torch.sort(torch.where(unique, slot, big), dim=1, stable=True).indices
    c = max_candidates
    sel = corder[:, :c]
    num_unique = unique.sum(dim=1).to(torch.int32)
    return (start_s.gather(1, sel),
            orient_s.gather(1, sel).to(torch.int32),
            unique.gather(1, sel),
            not_clean_s.gather(1, sel) == 0,
            support_s.gather(1, sel).to(torch.int32),
            {"num_candidates": num_unique, "candidate_overflow": num_unique > c})


def _split_seed_passes(cfg: AlignConfig, read_len: int):
    """(pass1 offsets, pass2 offsets): pass 1 is the first
    `first_pass_seeds` offsets plus the end-flush seed."""
    offsets = [o for o in cfg.seed_offsets if o + cfg.seed_len <= read_len]
    p1 = list(dict.fromkeys(offsets[: cfg.first_pass_seeds] + offsets[-1:]))
    p2 = [o for o in offsets if o not in p1]
    return tuple(p1), tuple(p2)


def _find_hits_two_pass(arrays: IndexArrays, cfg: AlignConfig, bases):
    """Two-pass seed escalation (see AlignConfig.first_pass_seeds): reads
    without a clean, agreeing pass-1 anchor are compacted into a
    batch*second_pass_fraction sub-batch and searched with the remaining
    seeds."""
    b = bases.shape[0]
    dev = bases.device
    p1, p2 = _split_seed_passes(cfg, bases.shape[1])
    s1, o1, v1, c1, diag1 = find_seed_hits(
        arrays, dataclasses.replace(cfg, seed_offsets=p1), bases)

    has_clean = (v1 & c1).any(dim=1)
    big = 2**30
    mn_s = torch.where(v1, s1, big).amin(dim=1)
    mx_s = torch.where(v1, s1, -big).amax(dim=1)
    mn_o = torch.where(v1, o1, big).amin(dim=1)
    mx_o = torch.where(v1, o1, -big).amax(dim=1)
    complete = has_clean & (mn_s == mx_s) & (mn_o == mx_o)

    incomplete = ~complete
    b2 = max(1, int(round(b * cfg.second_pass_fraction)))
    ridx = _compact_indices(incomplete, b2)
    rvalid = ridx < b
    sub_bases = bases[torch.clamp(ridx, max=b - 1)]
    s2, o2, v2, c2, _diag2 = find_seed_hits(
        arrays, dataclasses.replace(cfg, seed_offsets=p2), sub_bases)
    v2 = v2 & rvalid[:, None]

    h2 = s2.shape[1]
    rows = torch.where(rvalid, ridx, b)      # row b = scratch, sliced off

    def scatter(x, fill):
        out = torch.full((b + 1, h2), fill, dtype=x.dtype, device=dev)
        out[rows] = x
        return out[:b]

    start_f = torch.cat([s1, scatter(s2, 0)], dim=1)
    orient_f = torch.cat([o1, scatter(o2, 0)], dim=1)
    valid_f = torch.cat([v1, scatter(v2, False)], dim=1)
    clean_f = torch.cat([c1, scatter(c2, False)], dim=1)
    inc = incomplete.to(torch.int32)
    n_inc = inc.sum().to(torch.int32)
    diag1["pass2_reads"] = n_inc
    diag1["pass2_dropped"] = torch.clamp(n_inc - b2, min=0)
    # reads whose escalation was dropped by the sub-batch capacity are
    # forced through the dodgy (MAPQ-0) path
    diag1["pass2_dropped_mask"] = incomplete & (torch.cumsum(inc, 0) > b2)
    return start_f, orient_f, valid_f, clean_f, diag1


def _gather_candidates(arrays: IndexArrays, cfg: AlignConfig, bases):
    """Stages A+B: seed hits -> deduped candidate grid [B, K]."""
    _p1, p2 = _split_seed_passes(cfg, bases.shape[1])
    if cfg.first_pass_seeds > 0 and p2:
        start_f, orient_f, valid_f, clean_f, diag_a = _find_hits_two_pass(
            arrays, cfg, bases)
    else:
        start_f, orient_f, valid_f, clean_f, diag_a = find_seed_hits(
            arrays, cfg, bases)
    cand_start, cand_orient, cand_valid, cand_clean, support, diag_b = \
        dedup_candidates(start_f, orient_f, valid_f, clean_f, cfg.max_candidates)
    # well anchored: a neighbor-free seed supports it, or several seeds agree
    well_anchored = cand_clean | (support >= 2)
    diag = {**diag_a, **diag_b}
    k = min(cfg.max_scored_candidates, cfg.max_candidates)
    diag["scored_overflow"] = diag["num_candidates"] > k
    return (cand_start[:, :k], cand_orient[:, :k], cand_valid[:, :k],
            well_anchored[:, :k], diag)


def _score_ungapped(arrays: IndexArrays, cfg: AlignConfig, bases, quals,
                    cand_start, cand_orient, cand_valid):
    """Ungapped scoring of the valid (read, candidate) pairs.

    Valid pairs are compacted into a [B * scored_pairs_per_read] work
    queue; each gathers packed genome words (see _mismatch_planes).  The
    per-base log prob is lm for a match and lm + delta otherwise, summed
    in f32.  Reference semantics: UngappedAligner::alignUngapped, isMatch
    (an N read base matches; edit distance counts it).
    """
    b, read_len = bases.shape
    c = cand_start.shape[1]
    dev = bases.device

    rc_bases = bitops.revcomp_reads(bases)
    r_quals = bitops.reverse_quals(quals)
    packed_fwd = pack_reads(bases)
    packed_rev = pack_reads(rc_bases)
    t_match, t_mismatch = quality.log_tables(dev)

    def per_orient(base_arr, qual_arr):
        qi = qual_arr.to(torch.int64)
        lm = t_match[qi]
        return lm, t_mismatch[qi] - lm, base_arr >= dna.NUM_BASES

    lm_f, delta_f, n_f = per_orient(bases, quals)
    lm_r, delta_r, n_r = per_orient(rc_bases, r_quals)

    # ---- compact valid (read, candidate) pairs into a dense work queue
    flat_valid = cand_valid.reshape(-1)
    n_flat = b * c
    p = min(cfg.scored_pairs_per_read * b, n_flat)
    pair_idx = _compact_indices(flat_valid, p)
    pvalid = pair_idx < n_flat
    safe_idx = torch.clamp(pair_idx, max=n_flat - 1)
    row = safe_idx // c
    p_start = cand_start.reshape(-1)[safe_idx]
    p_rc = (cand_orient.reshape(-1)[safe_idx] == 1)[:, None]
    # reads whose valid pairs overflow the queue (forced MAPQ 0)
    cum = torch.cumsum(flat_valid.to(torch.int64), 0)
    dropped_row = (flat_valid & (cum > p)).reshape(b, c).any(dim=1)

    # positions overhanging the candidate's contig (located by the read's
    # middle base) are soft-clipped: excluded from counts and mass
    p_cid = _contig_of(arrays, p_start + read_len // 2)
    c_lo = arrays.contig_starts[p_cid][:, None]
    c_hi = arrays.contig_ends[p_cid][:, None]
    pos_j = p_start[:, None] + torch.arange(read_len, dtype=torch.int32,
                                            device=dev)
    in_contig = (pos_j >= c_lo) & (pos_j < c_hi)

    read_words = torch.where(p_rc, packed_rev[row], packed_fwd[row])
    code_mismatch, ref_n = _mismatch_planes(arrays, cfg, p_start, read_words,
                                            read_len)
    read_n = torch.where(p_rc, n_r[row], n_f[row])

    is_match = read_n | (~code_mismatch & ~ref_n)
    p_mismatches = (~is_match & in_contig).sum(dim=-1).to(torch.int32)
    p_edit = ((read_n | ref_n | code_mismatch) & in_contig).sum(dim=-1) \
        .to(torch.int32)
    delta = torch.where(p_rc, delta_r[row], delta_f[row])
    lm = torch.where(p_rc, lm_r[row], lm_f[row])
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    p_log_prob = sum_f32(torch.where(in_contig,
                                     torch.where(is_match, lm, lm + delta),
                                     zero))

    # ---- scatter back to the [B, C] grid (slot n_flat = scratch)
    scatter_idx = torch.where(pvalid, pair_idx, n_flat)

    def scatter(vals, fill):
        out = torch.full((n_flat + 1,), fill, dtype=vals.dtype, device=dev)
        out[scatter_idx] = vals
        return out[:n_flat].reshape(b, c)

    return (scatter(p_log_prob, -float("inf")), scatter(p_mismatches, 0),
            scatter(p_edit, 0), dropped_row)


def finalize_single_end(arrays: IndexArrays, cfg: AlignConfig, bases, quals,
                        cand_start, cand_orient, cand_valid, diag,
                        well_anchored=None):
    """Stages C+D: score candidates, pick best, MAPQ (single-end)."""
    if cfg.scatter_repeats:
        raise NotImplementedError(_NOT_PORTED_SCATTER)
    read_len = bases.shape[1]
    log_prob, mismatches, edit_distance, dropped = _score_ungapped(
        arrays, cfg, bases, quals, cand_start, cand_orient, cand_valid)

    # best candidate: lowest mismatch count, then highest log-prob
    # (TemplateBuilder::getBestFragment); argmin takes the first index on
    # ties, as jnp.argmin does (identical repeat copies score bit-equal)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=bases.device)
    order_key = torch.where(cand_valid,
                            mismatches.to(torch.float32) * 1e6 - log_prob, inf)
    best = torch.argmin(order_key, dim=1)[:, None]

    def take(x):
        return x.gather(1, best)[:, 0]

    aligned = cand_valid.any(dim=1)
    best_lp = take(log_prob)
    total_s, p_best_s, m_scale = quality.scaled_masses(log_prob, cand_valid,
                                                       best_lp)
    others_sum = torch.clamp(total_s - p_best_s, min=0.0)
    log_rog = quality.log_rest_of_genome_correction(
        genome_len_of(arrays, cfg), read_len)
    mapq_f = quality.mapping_quality_scaled(
        total_s, p_best_s, quality.rog_scaled(log_rog, m_scale))
    mapq = torch.clamp(torch.floor(mapq_f), 0, cfg.mapq_cap).to(torch.int32)
    mapq = torch.where(aligned, mapq, 0)
    dodgy = dropped
    if diag.get("scored_overflow") is not None:
        dodgy = dodgy | diag["scored_overflow"]
    if diag.get("pass2_dropped_mask") is not None:
        dodgy = dodgy | diag["pass2_dropped_mask"]
    mapq = torch.where(dodgy, cfg.dodgy_mapq, mapq)
    if cfg.dodgy_unaligned:
        aligned = aligned & ~dodgy
    if well_anchored is not None:
        # all supporting seeds have neighbors and no two agree -> score 0
        mapq = torch.where(take(well_anchored), mapq, 0)

    return {
        **_finder_stats_from_diag(diag),
        "aligned": aligned,
        "start": torch.where(aligned, take(cand_start), -1),
        "reverse": take(cand_orient) == 1,
        "mapq": mapq,
        "mismatches": take(mismatches),
        "edit_distance": take(edit_distance),
        "log_prob": best_lp,
        # non-best probability mass scaled by exp(-log_scale)
        "others_sum": others_sum,
        "log_scale": m_scale,
        "num_candidates": diag["num_candidates"],
        "candidate_overflow": diag["candidate_overflow"],
        # full candidate lists for the host long-indel polish
        "cand_start": cand_start,
        "cand_orient": cand_orient,
        "cand_valid": cand_valid,
        "cand_mismatches": mismatches,
    }


def score_candidates(arrays: IndexArrays, cfg: AlignConfig, bases, quals,
                     cand_start, cand_orient, cand_valid, well_anchored,
                     num_candidates, scored_overflow,
                     pass2_dropped_mask=None, finder_stats=None) -> dict:
    """Stage C on a gathered candidate grid -> the per-end dict of the pair
    resolver: start, orient, valid, cid, log_prob, sw_score, edit, obs_len,
    all [B, C]."""
    b, read_len = bases.shape
    log_prob, mismatches, edit_distance, dropped = _score_ungapped(
        arrays, cfg, bases, quals, cand_start, cand_orient, cand_valid)
    # located by the middle base: edge-overhanging candidates belong to the
    # contig that holds most of the read
    cid = _contig_of(arrays, cand_start + read_len // 2)
    dodgy = scored_overflow | dropped
    if pass2_dropped_mask is not None:
        dodgy = dodgy | pass2_dropped_mask
    return {
        "score_dropped": dropped,
        # untrackable repeat mass (or a dropped pass-2 escalation): the
        # pair resolver forces the dodgy score, as finalize_single_end does
        "dodgy": dodgy,
        "start": cand_start,
        "orient": cand_orient,
        "valid": cand_valid,
        "well_anchored": well_anchored,
        "cid": torch.where(cand_valid, cid, -1),
        "log_prob": log_prob,
        "sw_score": mismatches,          # ungapped SW score == mismatch count
        "mismatches": mismatches,
        "edit": edit_distance,
        "obs_len": torch.full(cand_start.shape, read_len, dtype=torch.int32,
                              device=bases.device),
        "num_candidates": num_candidates,
        "finder_stats": finder_stats or {},
    }


def score_end(arrays: IndexArrays, cfg: AlignConfig, bases, quals) -> dict:
    """Stages A+B+C for one read end: deduped, scored candidate lists."""
    cand_start, cand_orient, cand_valid, well_anchored, diag = \
        _gather_candidates(arrays, cfg, bases)
    return score_candidates(
        arrays, cfg, bases, quals, cand_start, cand_orient, cand_valid,
        well_anchored, diag["num_candidates"], diag["scored_overflow"],
        pass2_dropped_mask=diag.get("pass2_dropped_mask"),
        finder_stats=_finder_stats_from_diag(diag))


def quality_trim_device(bases, quals, cutoff: int, tail_masked):
    """3' quality trim (reference trimLowQualityEnd, Quality.cpp:72-120):
    walk leftward from the unmasked 3' end accumulating (cutoff - q), stop
    at the first negative sum, trim through the first running-max
    position when the peak is positive.

    Returns (masked bases, masked quals, per-read trim counts int32 [B]).
    """
    b, l = bases.shape
    dev = bases.device
    if cutoff <= 0 or l < MASK_READ_LENGTH_MIN:
        return bases, quals, torch.zeros(b, dtype=torch.int32, device=dev)
    start_j = (l - 1) - tail_masked.to(torch.int64)                # [B]
    t = torch.arange(l, dtype=torch.int64, device=dev)[None, :]
    j = start_j[:, None] - t                                       # [B, L]
    in_walk = j >= MASK_READ_LENGTH_MIN
    qv = quals.to(torch.int64).gather(1, torch.clamp(j, min=0))
    qs = torch.cumsum(torch.where(in_walk, cutoff - qv, 0), dim=1)
    stopped = (qs < 0) | ~in_walk
    alive = torch.cumsum(stopped.to(torch.int64), dim=1) == 0
    qs_m = torch.where(alive, qs, -2**31)
    peak = qs_m.amax(dim=1)
    t_peak = torch.argmax(qs_m, dim=1)                             # first max
    trims = torch.where(peak > 0, t_peak + 1, 0)
    cut_from = start_j + 1 - trims
    mask = (t >= cut_from[:, None]) & (t <= start_j[:, None]) & \
        (trims[:, None] > 0)
    return (bases.masked_fill(mask, dna.N), quals.masked_fill(mask, 0),
            trims.to(torch.int32))


def semialigned_clip_device(arrays: IndexArrays, cfg: AlignConfig, bases,
                            start, rev, aligned, trims):
    """Semialigned-ends clip of the chosen ungapped placement (reference
    SemialignedEndsClipper): soft-clip aligned ends inward until
    CONSECUTIVE_MATCHES_MIN consecutive matches.

    Emits per read: sa_do (the clip fires), sa_lead/sa_tail (final
    soft-clip spans incl. trim and contig overhang), sa_removed
    (mismatches clipped away) and sa_pos (final genome start); the host
    applies them (clippers.apply_semialigned_device).
    """
    b, l = bases.shape
    dev = bases.device
    g = genome_len_of(arrays, cfg)
    start = torch.where(aligned, start, 0).to(torch.int32)

    seq = torch.where(rev[:, None], bitops.revcomp_reads(bases), bases)
    code_mismatch, ref_n = _mismatch_planes(arrays, cfg, start,
                                            pack_reads(seq), l)
    read_n = seq >= dna.NUM_BASES
    match = read_n | (~code_mismatch & ~ref_n)

    col = torch.arange(l, dtype=torch.int32, device=dev)[None, :]
    pos_j = start[:, None] + col
    in_genome = (pos_j >= 0) & (pos_j < g)

    cid = _contig_of(arrays, start + l // 2)
    lead_c = torch.clamp(arrays.contig_starts[cid] - start, 0, l)
    tail_c = torch.clamp(start + l - arrays.contig_ends[cid], 0, l)
    trims = trims.to(torch.int32)
    lead = lead_c + torch.where(rev, trims, 0)
    tail = tail_c + torch.where(rev, 0, trims)

    core = (col >= lead[:, None]) & (col < l - tail[:, None]) & in_genome
    ok = match & core
    mism = ~match & core

    k = CONSECUTIVE_MATCHES_MIN

    def first_run_start(okm):
        idx = col.expand(okm.shape)
        last_false = torch.cummax(torch.where(~okm, idx, -1), dim=1).values
        hit = (idx - last_false) >= k
        j0 = torch.argmax(hit.to(torch.int32), dim=1)             # first hit
        return torch.where(hit.any(dim=1), j0 - (k - 1), 0)

    left = torch.clamp(first_run_start(ok) - lead, min=0)
    right = torch.clamp(first_run_start(ok.flip(1)) - tail, min=0)
    core_len = l - tail - lead
    do = ((left > 0) | (right > 0)) & (left + right + k < core_len) & aligned
    left_mm = (mism & (col < (lead + left)[:, None])).sum(dim=1)
    right_mm = (mism & (col >= (l - tail - right)[:, None])).sum(dim=1)
    return {
        "sa_do": do,
        "sa_lead": (lead + left).to(torch.int32),
        "sa_tail": (tail + right).to(torch.int32),
        "sa_removed": torch.where(do, left_mm + right_mm, 0).to(torch.int32),
        "sa_pos": (start + lead + left).to(torch.int32),
    }


def align_batch(arrays: IndexArrays, bases: torch.Tensor, quals: torch.Tensor,
                cfg: AlignConfig, tail_masked=None) -> dict:
    """Single-end alignment of one read batch on the arrays' device.

    bases/quals are uint8 [B, L]; tail_masked is an optional int32 [B]
    count of 3' bases already masked on the host (adapter clipping).
    Returns the dict of the JAX `align_batch`: the same keys and dtypes.
    """
    b = bases.shape[0]
    if tail_masked is None:
        tail_masked = torch.zeros(b, dtype=torch.int32, device=bases.device)
    qtrim = torch.zeros(b, dtype=torch.int32, device=bases.device)
    if cfg.quality_trim_cutoff > 0:
        bases, quals, qtrim = quality_trim_device(
            bases, quals, cfg.quality_trim_cutoff, tail_masked)
    cand_start, cand_orient, cand_valid, well_anchored, diag = \
        _gather_candidates(arrays, cfg, bases)
    res = finalize_single_end(arrays, cfg, bases, quals, cand_start,
                              cand_orient, cand_valid, diag, well_anchored)
    res["qtrim"] = qtrim
    if cfg.semialigned_clip:
        res.update(semialigned_clip_device(
            arrays, cfg, bases, res["start"], res["reverse"], res["aligned"],
            tail_masked + qtrim))
    return res


def mask_tail_device(bases, quals, tail_masked):
    """Mask the last `tail_masked` columns of each row (N / qual 0)."""
    l = bases.shape[1]
    col = torch.arange(l, dtype=torch.int32, device=bases.device)[None, :]
    m = col >= (l - tail_masked.to(torch.int32))[:, None]
    return bases.masked_fill(m, dna.N), quals.masked_fill(m, 0)
