"""Port's banded Smith-Waterman vs the JAX Pallas kernel and the numpy oracle.

The JAX kernel runs in Pallas interpret mode here (as tests/test_sw.py
runs it); the port's wrapper runs its plain torch version on CPU tensors.
All three must agree bit for bit: gfin and the packed traceback.  The
CUDA kernel is held against the plain version on the card
(tests/test_torch_cuda.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

from isaac_aligner_tpu.ops import sw as jsw
from isaac_aligner_tpu_torch import synthetic
from isaac_aligner_tpu_torch.align import gapped, quality
from isaac_aligner_tpu_torch.ops import sw


def _pairs(n, l, seed):
    rng = np.random.default_rng(seed)
    # query codes include N (4); windows the sentinel-free codes 0..4
    q = rng.integers(0, 5, (n, l)).astype(np.int32)
    db = rng.integers(0, 5, (n, l + sw.BAND - 1)).astype(np.int32)
    # half the pairs are near-matches so real tracebacks (not only the
    # NEG sentinel region) are compared
    for i in range(0, n, 2):
        off = int(rng.integers(0, sw.BAND))
        q[i] = db[i, off : off + l]
        mut = rng.random(l) < 0.05
        q[i] = np.where(mut, rng.integers(0, 4, l), q[i])
    return q, db


@pytest.mark.parametrize("scores", [sw.BWA_SCORES, sw.ELAND_SCORES],
                         ids=["bwa", "eland"])
@pytest.mark.parametrize("l", [40, 101])
@pytest.mark.parametrize("n", [16, 130])
def test_banded_sw_bit_equal_to_jax_and_numpy(n, l, scores):
    q, db = _pairs(n, l, seed=n * 1000 + l)
    g_jax, tb_jax = jsw.banded_sw(q, db, scores)
    g_jax, tb_jax = np.asarray(g_jax), np.asarray(tb_jax)
    g_np, tb_np = sw.banded_sw_numpy_batch(q, db, scores)
    g_t, tb_t = sw.banded_sw(torch.from_numpy(q), torch.from_numpy(db), scores)
    assert g_t.dtype == torch.float32 and tb_t.dtype == torch.int32
    assert tuple(tb_t.shape) == (n, -(-l // sw.TB_PACK), sw.BAND)
    np.testing.assert_array_equal(g_t.numpy(), g_jax)
    np.testing.assert_array_equal(tb_t.numpy(), tb_jax)
    np.testing.assert_array_equal(g_t.numpy(), g_np)
    np.testing.assert_array_equal(tb_t.numpy(), tb_np)


def _window_for(ref, pos, read_len):
    left = min(7, pos)
    return ref[pos - left : pos - left + read_len + sw.BAND - 1], left


def _align_one(query, db):
    g, tb = sw.banded_sw(torch.from_numpy(query[None].astype(np.int32)),
                         torch.from_numpy(db[None].astype(np.int32)))
    g = g.numpy()[0]
    exit_d = int(np.argmax(g))
    ops, first_db = sw.traceback(tb.numpy()[0], exit_d, len(query))
    return float(g[exit_d]), sw.ops_to_cigar(ops), first_db


def test_deletion_cigar():
    rng = np.random.default_rng(2)
    ref = rng.integers(0, 4, 300).astype(np.int32)
    read = np.concatenate([ref[100:120], ref[125:145]])
    db, left = _window_for(ref, 100, 40)
    score, cigar, first_db = _align_one(read, db)
    assert cigar == [(20, "M"), (5, "D"), (20, "M")]
    assert first_db == left
    assert score == -11 - 4 * 4


def test_insertion_cigar():
    rng = np.random.default_rng(3)
    ref = rng.integers(0, 4, 300).astype(np.int32)
    ins = rng.integers(0, 4, 3)
    read = np.concatenate([ref[100:118], ins, ref[118:137]])
    db, left = _window_for(ref, 100, 40)
    score, cigar, first_db = _align_one(read, db)
    # same outcome as the JAX kernel on this input (tests/test_sw.py)
    g_j, tb_j = jsw.banded_sw(read[None], db[None])
    exit_d = int(np.argmax(np.asarray(g_j)[0]))
    ops_j, first_j = jsw.traceback(np.asarray(tb_j)[0], exit_d, len(read))
    assert cigar == jsw.ops_to_cigar(ops_j)
    assert first_db == first_j
    assert score >= -11 - 4 * 2
    assert any(op == "I" for _, op in cigar)


def test_wrapper_checks_inputs():
    q = torch.zeros((4, 20), dtype=torch.int32)
    db = torch.zeros((4, 35), dtype=torch.int32)
    with pytest.raises(ValueError):
        sw.banded_sw(q, db[:, :30].contiguous())
    with pytest.raises(TypeError):
        sw.banded_sw(q.to(torch.int64), db)
    with pytest.raises(ValueError):
        sw.banded_sw(torch.zeros((20, 4), dtype=torch.int32).t(), db)


def test_cpu_path_is_not_counted_as_a_launch():
    before = sw.banded_sw.launches
    q, db = _pairs(4, 30, seed=1)
    sw.banded_sw(torch.from_numpy(q), torch.from_numpy(db))
    assert sw.banded_sw.launches == before


@pytest.mark.parametrize("n,l", [(0, 40), (3, 0)])
def test_empty_batch_shapes_match_numpy(n, l):
    q = np.zeros((n, l), np.int32)
    db = np.zeros((n, l + sw.BAND - 1), np.int32)
    g_np, tb_np = sw.banded_sw_numpy_batch(q, db)
    g_t, tb_t = sw.banded_sw(torch.from_numpy(q), torch.from_numpy(db))
    np.testing.assert_array_equal(g_t.numpy(), g_np)
    assert tuple(tb_t.shape) == tb_np.shape


def test_unpack_tb_round_trip():
    rng = np.random.default_rng(9)
    rows = rng.integers(0, 64, (23, sw.BAND)).astype(np.int32)
    np.testing.assert_array_equal(sw.unpack_tb(sw.pack_tb(rows), 23), rows)


# ---------------------------------------------------------------------------
# sw_walk: the traceback walk and rescore
# ---------------------------------------------------------------------------

GAPS = {"bwa": gapped.BWA, "eland": gapped.ELAND}


def _walk_inputs(n, l, gs, seed, offsets=None):
    rng = np.random.default_rng(seed)
    q, db, ql = synthetic.sw_walk_pairs(rng, n, l, offsets)
    g, tb = sw.banded_sw_numpy_batch(q.astype(np.int32), db.astype(np.int32),
                                     gs.sw_scores())
    return g, tb, q, db, ql


def _sw_walk(g, tb, q, db, ql, gs):
    """sw.sw_walk on CPU tensors of these arrays, with the float64
    quality tables and gs's normalized scores, as polish_gapped calls it."""
    return sw.sw_walk(*(torch.from_numpy(x) for x in (g, tb, q, db, ql)),
                      *quality.log_tables_f64("cpu"), gs.norms()).numpy()


def _check_walk(g, tb, q, db, ql, gs):
    """The plain sw_walk equals the host oracle (traceback from numpy's
    argmax, ops_to_cigar, rescore_cigar over the window) field for field,
    the log-probability with ==; runs zero past the last."""
    out = _sw_walk(g, tb, q, db, ql, gs)
    n, l = q.shape
    assert out.shape == (n, sw.WALK_HDR + sw.walk_runs(l))
    w = sw.decode_walk(out)
    for k in range(n):
        ops, first_db = sw.traceback(tb[k], int(np.argmax(g[k])), l)
        cigar = sw.ops_to_cigar(ops)
        is_gapped = any(op != "M" for _, op in cigar)
        assert w["first_db"][k] == first_db
        assert w["runs"][k] == len(cigar)
        assert sw.walk_cigar(out[k]) == "".join(f"{n}{op}" for n, op in cigar)
        assert not out[k, sw.WALK_HDR + len(cigar):].any()
        assert w["flags"][k] == (sw.WALK_GAPPED if is_gapped else 0)
        want = (gapped.rescore_cigar(db[k], first_db, q[k], ql[k], cigar, gs)
                if is_gapped else (0.0, 0, 0, 0))
        got = (w["log_prob"][k], w["mismatches"][k], w["edit"][k],
               w["norm"][k])
        assert got == want, (k, got, want)
    return out, w


@pytest.mark.parametrize("gs", list(GAPS), ids=list(GAPS))
@pytest.mark.parametrize("l", [100, 150, 151])
def test_sw_walk_plain_equals_host_oracle(l, gs):
    g, tb, q, db, ql = _walk_inputs(48, l, GAPS[gs], seed=l)
    _out, w = _check_walk(g, tb, q, db, ql, GAPS[gs])
    gapped_rows = (w["flags"] & sw.WALK_GAPPED) != 0
    assert 0 < gapped_rows.sum() < len(q)       # gapped and all-M walks
    assert (q == 4).any() and (db == 4).any()


def test_sw_walk_gfin_ties_take_the_first_largest():
    gs = gapped.BWA
    g, tb, q, db, ql = _walk_inputs(12, 100, gs, seed=7)
    g = g.copy()
    g[0::3] = 0.0                               # every d ties: exit 0
    g[1::3] = -50.0
    g[1::3, 4] = g[1::3, 11] = -3.0             # ties at 4 and 11: exit 4
    _check_walk(g, tb, q, db, ql, gs)


@pytest.mark.parametrize("gs", list(GAPS), ids=list(GAPS))
def test_sw_walk_band_edges(gs):
    """Near-matches at band offset 0 and 15: walks exit at d = 0 and 15."""
    g, tb, q, db, ql = _walk_inputs(40, 100, GAPS[gs], seed=15,
                                    offsets=[0, sw.BAND - 1])
    exit_d = g.argmax(axis=1)
    assert (exit_d[0::2] == 0).any() and (exit_d[1::2] == sw.BAND - 1).any()
    _check_walk(g, tb, q, db, ql, GAPS[gs])


def test_sw_walk_worst_case_tb_fits_the_run_buffer():
    gs = gapped.BWA
    l = 100
    _g, _tb, q, db, ql = _walk_inputs(2, l, gs, seed=3)
    tb = np.stack([synthetic.worst_case_walk_tb(l)] * 2)
    g = np.zeros((2, sw.BAND), np.float32)
    g[:, sw.BAND - 1] = 1.0
    _out, w = _check_walk(g, tb, q, db, ql, gs)
    assert (w["runs"] > 2 * l - 10).all()
    assert (w["runs"] <= sw.walk_runs(l)).all()


def test_sw_walk_quality_past_the_tables_is_bad():
    gs = gapped.BWA
    g, tb, q, db, ql = _walk_inputs(24, 100, gs, seed=4)
    out = _sw_walk(g, tb, q, db, ql, gs)
    k = int(np.nonzero(out[:, 2] == sw.WALK_GAPPED)[0][0])
    ql = ql.copy()
    ql[k] = quality.MAX_Q + 20
    bad = _sw_walk(g, tb, q, db, ql, gs)
    assert bad[k, 2] == sw.WALK_BAD and not np.delete(bad[k], 2).any()
    assert np.array_equal(np.delete(bad, k, 0), np.delete(out, k, 0))


def test_sw_walk_checks_inputs():
    gs = gapped.BWA
    g, tb, q, db, ql = (torch.from_numpy(x)
                        for x in _walk_inputs(4, 30, gs, seed=1))
    lm, lmm = quality.log_tables_f64("cpu")
    norms = gs.norms()
    before = sw.sw_walk.launches
    sw.sw_walk(g, tb, q, db, ql, lm, lmm, norms)
    assert sw.sw_walk.launches == before
    with pytest.raises(ValueError, match="query"):
        sw.sw_walk(g, tb, q.to(torch.int32), db, ql, lm, lmm, norms)
    with pytest.raises(ValueError, match="window"):
        sw.sw_walk(g, tb, q, db[:, :40].contiguous(), ql, lm, lmm, norms)
    with pytest.raises(ValueError, match="contiguous"):
        sw.sw_walk(g, tb, q, db, ql.t().contiguous().t(), lm, lmm, norms)
    with pytest.raises(ValueError, match="log_match"):
        sw.sw_walk(g, tb, q, db, ql, lm.float(), lmm, norms)
    with pytest.raises(ValueError, match="log_mismatch"):
        sw.sw_walk(g, tb, q, db, ql, lm, lmm[:50], norms)
    with pytest.raises(ValueError, match="norms"):
        sw.sw_walk(g, tb, q, db, ql, lm, lmm, norms[:3])


@pytest.mark.parametrize("gs", list(GAPS), ids=list(GAPS))
def test_polish_gapped_equals_jax(gs):
    """The port's polish (walks, rescore and acceptance through sw_walk,
    vectorized) leaves the same res as the JAX package's per-pair loop, on
    both ends of a paired batch; sw_accepted counts the rows it changed."""
    import copy
    import types

    from isaac_aligner_tpu.align import gapped as jgapped
    from isaac_aligner_tpu_torch.align.pipeline import AlignConfig

    rng = np.random.default_rng(11)
    genome = synthetic.make_genome(rng, 60_000, families=((600, 8, 0.02),),
                                   n_island=(30_000, 300))
    index = types.SimpleNamespace(genome=genome)
    cfg = AlignConfig(seed_len=32, seed_offsets=(0,))
    res, ends = synthetic.polish_batch(rng, genome, 192)
    ours, theirs = copy.deepcopy(res), copy.deepcopy(res)
    pairs = 0
    tally = types.SimpleNamespace(sw_accepted=0)
    for sfx, (bases, quals) in ends.items():
        pairs += gapped.polish_gapped(index, cfg, ours, bases, "cpu", sfx,
                                      quals=quals, gs=GAPS[gs], tally=tally)
        jgapped.polish_gapped(index, cfg, theirs, bases, sfx, quals=quals,
                              gs=jgapped.GapScoring(**dataclasses.asdict(
                                  GAPS[gs])))
    assert ours.keys() == theirs.keys()
    for key in ours:
        if isinstance(ours[key], list):
            assert ours[key] == theirs[key], key
        else:
            assert ours[key].dtype == theirs[key].dtype, key
            np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)
    changed = sum(a != b for sfx in ends for a, b in
                  zip(res["cigar" + sfx], ours["cigar" + sfx]))
    assert tally.sw_accepted == changed
    assert 0 < changed < pairs
