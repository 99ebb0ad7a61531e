"""The port's seed stage beyond exact 16/32-mers vs the JAX package, on the
same numpy inputs on the CPU: 4-word (64-mer) key search and the prefix
range of the neighbor pass, `scatter_hash`, and `find_seed_hits` /
`align_batch` in each mode (64-mer seeds over a 32-mer index, a true
64-mer index, the Hamming<=1 neighbor pass with and without
--ignore-repeats, 16-mer seeds with the threshold set, --scatter-repeats),
the paired pick with scatter on planted exact ties, and `plane_bytes` of a
64-mer index.  `PairedAligner` with scatter and the neighbor pass on runs
in `tests/test_torch_paired.py`'s workflow case, byte-equal to the JAX
package's BAM.

Integers and bools must be equal.  Floats agree to f32 reduction order:
rtol 1e-5, and atol 1e-5 for `others_sum` (a difference of two sums on
the scale where the best mass is 1, as `tests/test_torch_pairs.py`
states); MAPQ may differ by floor flips only (`tests/test_torch_pipeline.py`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaac_aligner_tpu import aligner as jaligner
from isaac_aligner_tpu import dna as jdna
from isaac_aligner_tpu.align import pairs as jpairs
from isaac_aligner_tpu.align import pipeline as jpipe
from isaac_aligner_tpu.index.build import build_index
from isaac_aligner_tpu.io.fasta import genome_from_sequences
from isaac_aligner_tpu.ops import search as jsearch
from isaac_aligner_tpu_torch.align import pairs
from isaac_aligner_tpu_torch.align import pipeline as tpipe
from isaac_aligner_tpu_torch.ops import search

from test_long_kmer_index import repeat_genome  # noqa: F401 (a fixture)
from test_neighbor_match import _fixture as neighbor_fixture
from test_torch_host import to_port_index
from test_torch_paired import L as PAIR_L
from test_torch_pairs import TLS, _as, random_ends
from test_torch_pipeline import FLOAT_FIELDS, rich_fixture

I32_MAX = 2**31 - 1


# -- search -----------------------------------------------------------------

def _planes_4word(seed=3, n=700):
    """Sorted, biased 4-word key planes with long runs of equal hi and mid
    words (small alphabets), the all-T key as the last real record, padded
    to a power of two with I32_MAX; and 4-word queries: hits, misses in
    each word, random keys and the all-T key."""
    rng = np.random.default_rng(seed)
    words = [rng.integers(-3, 3, n), rng.integers(-2, 2, n),
             rng.integers(-2, 2, n),
             rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64)]
    words = [w.astype(np.int32) for w in words]
    for w in words:
        w[-1] = I32_MAX                       # the all-T 64-mer
    order = np.lexsort(words[::-1])
    real = [w[order] for w in words]
    n_pad = search.pad_pow2(n)
    planes = [np.concatenate([w, np.full(n_pad - n, I32_MAX, np.int32)])
              for w in real]
    pick = rng.integers(0, n, 96)
    q = [w[pick].copy() for w in real]
    for i in range(4):
        q[i][i::8] += 1                       # misses in each word
    q = [np.concatenate([w, rng.integers(-4, 4, 24).astype(np.int32),
                         np.full(8, I32_MAX, np.int32)]) for w in q]
    return real, planes, [w.reshape(-1, 8) for w in q]


@pytest.mark.parametrize("mode", ["sorted_range", "bucketed", "bucketed_cap"])
def test_sorted_range_4word_equals_jax(mode):
    real, planes, q = _planes_4word()
    n_real = real[0].shape[0]
    jp = [jnp.asarray(p) for p in planes]
    jq = [jnp.asarray(x) for x in q]
    tp = [torch.from_numpy(p) for p in planes]
    tq = [torch.from_numpy(x) for x in q]
    if mode == "sorted_range":
        want = jsearch.sorted_range(jp[0], jp[3], jq[0], jq[3], n_real,
                                    key_mids=tuple(jp[1:3]),
                                    q_mids=tuple(jq[1:3]))
        got = search.sorted_range(tp[0], tp[3], tq[0], tq[3], n_real,
                                  key_mids=tuple(tp[1:3]),
                                  q_mids=tuple(tq[1:3]))
    else:
        starts, log2 = tpipe.build_bucket_table(real[0], 16)
        js, jl = jpipe.build_bucket_table(real[0], 16)
        np.testing.assert_array_equal(starts, js)
        cap = 2 if mode == "bucketed_cap" else None
        want = jsearch.sorted_range_bucketed(
            jp[0], jp[3], jq[0], jq[3], n_real, jnp.asarray(js), 16, jl,
            count_cap_log2=cap, key_mids=tuple(jp[1:3]), q_mids=tuple(jq[1:3]))
        got = search.sorted_range_bucketed(
            tp[0], tp[3], tq[0], tq[3], n_real, torch.from_numpy(starts), 16,
            log2, count_cap_log2=cap, key_mids=tuple(tp[1:3]),
            q_mids=tuple(tq[1:3]))
    for a, e in zip(got, want):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(e))
    count = got[1].numpy()
    assert (count > 0).any() and (count == 0).any()
    # the all-T queries find the one real all-T record, not the padding
    assert (count[-1] == 1).all()


def test_sorted_prefix_range_equals_jax():
    real, planes, q = _planes_4word(seed=4)
    n_real = real[0].shape[0]
    want = jsearch.sorted_prefix_range(jnp.asarray(planes[0]),
                                       jnp.asarray(planes[3]),
                                       jnp.asarray(q[0]), n_real)
    got = search.sorted_prefix_range(torch.from_numpy(planes[0]),
                                     torch.from_numpy(q[0]), n_real)
    for a, e in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(e))
    assert got[1].max() > 50                  # long equal-prefix blocks


@pytest.mark.parametrize("extra", [False, True], ids=["row_pos", "row_pos_extra"])
def test_scatter_hash_equals_jax(extra):
    rng = np.random.default_rng(8)
    edge = np.array([0, -1, 1, -2**31, 2**31 - 1, -256, 0x7FFF0000], np.int64)
    vals = [np.concatenate([edge, rng.integers(-2**31, 2**31, 249,
                                               dtype=np.int64)])
            .astype(np.int32) for _ in range(3)]
    for v in vals:
        rng.shuffle(v)
    args = vals if extra else vals[:2]
    want = np.asarray(jpipe.scatter_hash(*[jnp.asarray(v) for v in args]))
    got = tpipe.scatter_hash(*[torch.from_numpy(v) for v in args])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).all() and len(np.unique(want)) > 250


# -- find_seed_hits and align_batch, per mode ---------------------------------

def _batch_rows(rows):
    return np.stack([np.asarray(r, np.uint8) for r in rows])


def _ext_mode():
    """64-mer seeds searched as 32-mers over a 32-mer index, on the rich
    fixture's genome (N island at 20,000); plus reads whose first 32-mer
    matches and whose extension runs into the N island with A where the
    genome holds N, so only the N-bit check refuses them."""
    index, _sim, bases, quals, tail, cfg = rich_fixture(n_reads=96)
    g = index.genome.codes
    extra = []
    for s in (19_950, 19_940, 19_960):
        r = g[s:s + 100].copy()
        r[r >= 4] = 0
        extra.append(r)
    bases = np.concatenate([bases, _batch_rows(extra)])
    quals = np.concatenate([quals, np.full((3, 100), 35, np.uint8)])
    tail = np.concatenate([tail, np.zeros(3, np.int32)])
    cfg = dataclasses.replace(cfg, seed_len=64, index_seed_len=32,
                              seed_offsets=jpipe.default_seed_offsets(100, 64))
    return index, bases, quals, tail, cfg


def _index64_mode(repeat_genome):
    """A true 64-mer index (four key planes) over a genome whose 32-mers
    are all repeats past the threshold while each 64-mer is unique."""
    genome, pair_starts = repeat_genome
    index = build_index(genome, seed_len=64, repeat_threshold=4)
    g = genome.codes
    rows = [g[p:p + 80] for p in list(pair_starts.values())[:16]]
    rows += [jdna.revcomp(g[p:p + 80]) for p in list(pair_starts.values())[16:24]]
    rows.append(np.full(80, 3, np.uint8))            # all-T: the sentinel key
    rng = np.random.default_rng(5)
    rows += [rng.integers(0, 4, 80) for _ in range(3)]
    bases = _batch_rows(rows)
    return index, bases, np.full(bases.shape, 35, np.uint8), None, \
        jpipe.AlignConfig(seed_len=64, index_seed_len=64,
                          seed_offsets=jpipe.default_seed_offsets(80, 64),
                          repeat_threshold=4, max_hits_per_seed=4)


def _neighbor_rows(genome, seed=6):
    """64 bp reads of the neighbor fixture: one substitution in the suffix
    half of each 32-mer seed window (every exact seed misses), exact reads,
    reverse-complemented mutated reads, and junk."""
    rng = np.random.default_rng(seed)
    g = genome.codes
    rows = []
    for i in range(40):
        s = int(rng.integers(0, g.size - 64))
        r = g[s:s + 64].copy()
        if i % 4 != 3:
            for p in (20, 52):
                r[p] = (r[p] + 1) % 4
        rows.append(jdna.revcomp(r) if i % 3 == 1 else r)
    rows += [rng.integers(0, 4, 64) for _ in range(4)]
    return _batch_rows(rows)


def _neighbor_mode(ignore_repeats: bool):
    genome, index = neighbor_fixture()
    bases = _neighbor_rows(genome)
    # --ignore-repeats: every exact seed counts as a repeat (threshold 0),
    # so only the inexact pass, which the option unblocks, can place reads
    cfg = jpipe.AlignConfig(seed_len=32,
                            seed_offsets=jpipe.default_seed_offsets(64, 32),
                            neighborhood_size_threshold=100,
                            ignore_repeats=ignore_repeats,
                            repeat_threshold=0 if ignore_repeats else 10)
    return index, bases, np.full(bases.shape, 30, np.uint8), None, cfg


def _seed16_mode():
    genome, _index = neighbor_fixture()
    index = build_index(genome, seed_len=16)
    bases = _neighbor_rows(genome, seed=7)
    cfg = jpipe.AlignConfig(seed_len=16,
                            seed_offsets=jpipe.default_seed_offsets(64, 16),
                            neighborhood_size_threshold=100)
    return index, bases, np.full(bases.shape, 30, np.uint8), None, cfg


def scatter_genome():
    """`tests/test_options_round4.py::test_scatter_repeats_spreads_ties`'s
    genome: two exact copies of a 200 bp unit in unique sequence."""
    rng = np.random.default_rng(11)
    uniq = "".join("ACGT"[i] for i in rng.integers(0, 4, 3000))
    copy = "".join("ACGT"[i] for i in rng.integers(0, 4, 200))
    seq = uniq[:1000] + copy + uniq[1000:2000] + copy + uniq[2000:]
    return genome_from_sequences([("cS", seq)])


def _scatter_mode():
    genome = scatter_genome()
    index = build_index(genome, seed_len=32)
    g = genome.codes
    rows = [g[1000 + o:1064 + o] for o in range(0, 128, 8)]
    rows += [jdna.revcomp(g[1000 + o:1064 + o]) for o in (4, 20, 60)]
    rows += [g[o:o + 64] for o in (100, 2500, 3100)]
    bases = _batch_rows(rows)
    cfg = jpipe.AlignConfig(seed_len=32,
                            seed_offsets=jpipe.default_seed_offsets(64, 32),
                            scatter_repeats=True)
    return index, bases, np.full(bases.shape, 35, np.uint8), None, cfg


def _mode(name, repeat_genome):
    if name == "ext_over_32":
        return _ext_mode()
    if name == "index64":
        return _index64_mode(repeat_genome)
    if name == "neighbors":
        return _neighbor_mode(False)
    if name == "neighbors_ignore_repeats":
        return _neighbor_mode(True)
    if name == "seed16_threshold":
        return _seed16_mode()
    return _scatter_mode()


def _assert_align_fields(ref: dict, out: dict):
    assert sorted(out) == sorted(ref)
    for k in sorted(ref):
        a, e = out[k], ref[k]
        assert a.dtype == e.dtype and a.shape == e.shape, k
        if k in FLOAT_FIELDS:
            np.testing.assert_allclose(a, e, rtol=1e-5,
                                       atol=1e-5 if k == "others_sum" else 0,
                                       err_msg=k)
        elif k != "mapq":
            np.testing.assert_array_equal(a, e, err_msg=k)
    d = np.abs(out["mapq"].astype(np.int64) - ref["mapq"].astype(np.int64))
    assert d.max(initial=0) <= 1
    assert int((d > 0).sum()) <= max(2, int(0.005 * d.size))


_find_seed_hits_jit = jax.jit(jpipe.find_seed_hits, static_argnums=(1,))

MODES = ["ext_over_32", "index64", "neighbors", "neighbors_ignore_repeats",
         "seed16_threshold", "scatter"]


@pytest.mark.parametrize("mode", MODES)
def test_seed_mode_equals_jax(mode, repeat_genome):
    index, bases, quals, tail, cfg = _mode(mode, repeat_genome)
    cfg = jaligner._with_bucket_log2(cfg, index)
    cfg = dataclasses.replace(cfg, genome_len=index.genome.total_length)
    tcfg = tpipe.AlignConfig(**dataclasses.asdict(cfg))
    jarr = jpipe.prepare_index(index, upload_codes=False)
    tarr = tpipe.prepare_index(to_port_index(index), "cpu")
    assert len(tarr.key_mids) == len(jarr.key_mids)

    # stage A on the whole batch
    want = _find_seed_hits_jit(jarr, cfg, jnp.asarray(bases))
    got = tpipe.find_seed_hits(tarr, tcfg, torch.from_numpy(bases))
    for a, e in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(e))
    assert sorted(got[4]) == sorted(want[4])
    for k in want[4]:
        np.testing.assert_array_equal(got[4][k].numpy(), np.asarray(want[4][k]),
                                      err_msg=k)

    ref = jpipe.align_batch_jit(jarr, jnp.asarray(bases), jnp.asarray(quals),
                                cfg, None if tail is None
                                else jnp.asarray(tail))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    out = tpipe.align_batch(tarr, torch.from_numpy(bases),
                            torch.from_numpy(quals), tcfg,
                            None if tail is None else torch.from_numpy(tail))
    out = {k: v.numpy() for k, v in out.items()}
    _assert_align_fields(ref, out)

    aligned = out["aligned"]
    if mode == "ext_over_32":
        valid = got[2].numpy()
        assert not valid[-3:].any()       # the N-bit check refused them
        assert aligned[:-3].mean() > 0.3
    elif mode == "index64":
        # every 32-mer is a repeat, every 64-mer unique: all probes place
        assert aligned[:24].all() and not aligned[24]
        assert (out["mapq"][:24] > 0).all()
    elif mode.startswith("neighbors"):
        nb = got[4]["neighbor_hits"].numpy()
        assert nb.sum() > 0 and aligned[:40].mean() > 0.9
    elif mode == "seed16_threshold":
        assert "neighbor_hits" not in got[4]     # the pass runs at k=32 only
    else:
        starts = out["start"][:16]
        assert ((starts < 1200) & aligned[:16]).any() and \
            ((starts >= 2200) & aligned[:16]).any()


# -- pairs --------------------------------------------------------------------

def _tied_ends(seed: int):
    """`random_ends` with an exact tie planted in every 4th row: slot 6 of
    each end copies slot 0 five bases further on, and slot 0 is the best
    valid candidate, so the pairs (0, 0), (0, 6), (6, 0) and (6, 6) tie."""
    e1, e2 = random_ends(seed)
    rows = np.arange(0, e1["start"].shape[0], 4)
    for e in (e1, e2):
        for k in ("orient", "valid", "cid", "log_prob", "sw_score",
                  "mismatches", "edit", "obs_len", "well_anchored"):
            e[k][rows, 6] = e[k][rows, 0]
        e["start"][rows, 6] = e["start"][rows, 0] + 5
        e["valid"][rows, 0] = e["valid"][rows, 6] = True
        e["cid"][rows, 0] = e["cid"][rows, 6] = 0
        e["log_prob"][rows, 0] = e["log_prob"][rows, 6] = -0.5
        e["sw_score"][rows, 0] = e["sw_score"][rows, 6] = 0
    return e1, e2


@pytest.mark.parametrize("seed", [0, 1])
def test_resolve_pairs_scatter_equals_jax(seed):
    e1, e2 = _tied_ends(seed)
    jcfg = jpipe.AlignConfig(scatter_repeats=True)
    tcfg = tpipe.AlignConfig(scatter_repeats=True)
    log_rog = jpipe.quality.log_rest_of_genome_correction(4_600_000, 2 * PAIR_L)
    j = jax.jit(jpairs.resolve_pairs, static_argnums=(0, 4))(
        jcfg, jpairs.TlsStatic(**TLS), _as(e1, "jax"), _as(e2, "jax"), log_rog)
    t = pairs.resolve_pairs(tcfg, pairs.TlsStatic(**TLS), _as(e1, "t"),
                            _as(e2, "t"), log_rog)
    for k in ("resolved", "i1", "i2", "proper", "template_length"):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]), k)
    plain = pairs.resolve_pairs(tpipe.AlignConfig(), pairs.TlsStatic(**TLS),
                                _as(e1, "t"), _as(e2, "t"), log_rog)
    # the hash moves some exact ties off the first index
    moved = (plain["i1"] != t["i1"]) | (plain["i2"] != t["i2"])
    assert 0 < int(moved.sum()) and not moved[1::4].any()


# -- planes -------------------------------------------------------------------

def test_plane_bytes_of_64mer_index_is_what_prepare_index_allocates(
        repeat_genome):
    genome, _ = repeat_genome
    index = to_port_index(build_index(genome, seed_len=64, repeat_threshold=4))
    arrays = tpipe.prepare_index(index, "cpu")
    planes = [getattr(arrays, f.name) for f in dataclasses.fields(arrays)
              if isinstance(getattr(arrays, f.name), torch.Tensor)]
    planes += list(arrays.key_mids)
    assert len(arrays.key_mids) == 2
    assert all(m.shape == arrays.key_hi.shape for m in arrays.key_mids)
    assert tpipe.plane_bytes(index) == sum(t.numel() * t.element_size()
                                           for t in planes)
