"""Hand-written CUDA kernels vs their plain torch versions, on the card.

This file imports no jax, so it also runs on a GPU machine without JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -q -s

(--noconftest skips tests/conftest.py, which configures jax).  Where
torch.cuda.is_available() is False every test here skips.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from isaac_aligner_tpu_torch.ops import sw


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _pairs(n, l, seed, offsets=None):
    """Random pairs; the even ones are near-matches (5% substitutions) at
    a random band offset, or at `offsets` in turn, so real tracebacks are
    compared, not only the NEG sentinel region."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 5, (n, l)).astype(np.int32)
    db = rng.integers(0, 5, (n, l + sw.BAND - 1)).astype(np.int32)
    rows = np.arange(0, n, 2) if offsets is None else np.arange(n)
    off = (rng.integers(0, sw.BAND, rows.size) if offsets is None
           else np.resize(np.asarray(offsets), rows.size))
    near = db[rows[:, None], off[:, None] + np.arange(l)[None, :]]
    mut = rng.random(near.shape) < 0.05
    q[rows] = np.where(mut, rng.integers(0, 4, near.shape), near)
    return q, db


def _check_kernel(dev, q, db, scores, oracle_rows=64):
    """One launch, bit-equal to banded_sw_torch on the same CUDA tensors
    and, on the first `oracle_rows` pairs, to the numpy oracle."""
    qd = torch.from_numpy(q.astype(np.uint8)).to(dev)
    dbd = torch.from_numpy(db.astype(np.uint8)).to(dev)
    before = sw.banded_sw.launches
    g_k, tb_k = sw.banded_sw(qd, dbd, scores)
    torch.cuda.synchronize()
    assert sw.banded_sw.launches == before + 1
    g_p, tb_p = sw.banded_sw_torch(qd, dbd, scores)
    assert torch.equal(g_k, g_p)
    assert torch.equal(tb_k, tb_p), int((tb_k != tb_p).sum())
    g_n, tb_n = sw.banded_sw_numpy_batch(q[:oracle_rows], db[:oracle_rows],
                                         scores)
    np.testing.assert_array_equal(g_k[:oracle_rows].cpu().numpy(), g_n)
    np.testing.assert_array_equal(tb_k[:oracle_rows].cpu().numpy(), tb_n)
    return g_k, tb_k


# lengths 1..400 (2 x 250 bp libraries) at the polish's batch; batch sizes
# that leave a ragged last warp, up to more pairs than one wave holds
LENGTHS = [1, 4, 5, 100, 101, 150, 251, 400]
BATCHES = [1, 3, 896, 8_192, 65_537]
SHAPES = ([(1000, 100), (300, 101), (1, 37)] + [(896, l) for l in LENGTHS]
          + [(n, 100) for n in BATCHES] + [(65_537, 150), (5, sw.MAX_LEN)])


@pytest.mark.cuda
@pytest.mark.parametrize("scores", [sw.BWA_SCORES, sw.ELAND_SCORES],
                         ids=["bwa", "eland"])
@pytest.mark.parametrize("n,l", SHAPES)
def test_banded_sw_kernel_bit_equal_to_plain_and_numpy(cuda_device, n, l,
                                                       scores):
    q, db = _pairs(n, l, seed=n + l)
    _check_kernel(cuda_device, q, db, scores)


@pytest.mark.cuda
@pytest.mark.parametrize("scores", [sw.BWA_SCORES, sw.ELAND_SCORES],
                         ids=["bwa", "eland"])
@pytest.mark.parametrize("l", [100, 101])
def test_banded_sw_kernel_band_edges(cuda_device, l, scores):
    """Every pair a near-match at band offset 0 or 15: the lanes at both
    edges of the band carry the real tracebacks."""
    q, db = _pairs(899, l, seed=l, offsets=[0, sw.BAND - 1])
    g_k, _tb = _check_kernel(cuda_device, q, db, scores, oracle_rows=128)
    exit_d = g_k.argmax(dim=1).cpu().numpy()
    assert (exit_d[0::2] == 0).mean() > 0.9
    assert (exit_d[1::2] == sw.BAND - 1).mean() > 0.9


@pytest.mark.cuda
def test_banded_sw_over_max_len_raises(cuda_device):
    q = torch.zeros((3, sw.MAX_LEN + 1), dtype=torch.uint8, device=cuda_device)
    db = torch.zeros((3, sw.MAX_LEN + sw.BAND), dtype=torch.uint8,
                     device=cuda_device)
    before = sw.banded_sw.launches
    with pytest.raises(ValueError, match="L <="):
        sw.banded_sw(q, db)
    assert sw.banded_sw.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("n,l", [(0, 100), (5, 0)])
def test_banded_sw_empty_batch_is_not_launched(cuda_device, n, l):
    q = torch.zeros((n, l), dtype=torch.int32, device=cuda_device)
    db = torch.zeros((n, l + sw.BAND - 1), dtype=torch.int32,
                     device=cuda_device)
    before = sw.banded_sw.launches
    g_k, tb_k = sw.banded_sw(q, db)
    assert sw.banded_sw.launches == before
    g_p, tb_p = sw.banded_sw_torch(q, db)
    assert torch.equal(g_k, g_p) and torch.equal(tb_k, tb_p)


@pytest.mark.cuda
def test_banded_sw_on_second_card():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    dev = torch.device("cuda:1")
    q, db = _pairs(300, 100, seed=11)
    torch.cuda.set_device(0)
    g_k, tb_k = sw.banded_sw(torch.from_numpy(q).to(dev),
                             torch.from_numpy(db).to(dev))
    torch.cuda.synchronize(dev)
    assert g_k.device == dev
    g_n, tb_n = sw.banded_sw_numpy_batch(q, db)
    np.testing.assert_array_equal(g_k.cpu().numpy(), g_n)
    np.testing.assert_array_equal(tb_k.cpu().numpy(), tb_n)


@pytest.mark.cuda
def test_banded_sw_uint8_inputs_and_report(cuda_device):
    from isaac_aligner_tpu_torch.ops._build import build_info

    q, db = _pairs(256, 100, seed=5)
    g32, tb32 = sw.banded_sw(torch.from_numpy(q).to(cuda_device),
                             torch.from_numpy(db).to(cuda_device))
    g8, tb8 = sw.banded_sw(
        torch.from_numpy(q.astype(np.uint8)).to(cuda_device),
        torch.from_numpy(db.astype(np.uint8)).to(cuda_device))
    assert torch.equal(g32, g8) and torch.equal(tb32, tb8)
    report, seconds = build_info("banded_sw")
    print(f"\nbanded_sw build: {seconds:.1f} s\n{report}")


def _walk_on(dev, q, db, ql, gs, g=None, tb=None):
    """(kernel rows, plain rows) of sw_walk on the same CUDA tensors, after
    banded_sw on them (or the given gfin and tb); one kernel launch."""
    qd, dbd, qld = (torch.from_numpy(x).to(dev) for x in (q, db, ql))
    if g is None:
        gd, tbd = sw.banded_sw(qd, dbd, gs.sw_scores())
    else:
        gd, tbd = torch.from_numpy(g).to(dev), torch.from_numpy(tb).to(dev)
    from isaac_aligner_tpu_torch.align import quality

    args = (gd, tbd, qd, dbd, qld, *quality.log_tables_f64(dev), gs.norms())
    before = sw.sw_walk.launches
    got = sw.sw_walk(*args)
    torch.cuda.synchronize()
    assert sw.sw_walk.launches == before + 1
    want = sw.sw_walk_torch(*args)
    return got.cpu().numpy(), want.cpu().numpy()


def _assert_walks_equal(got, want):
    """Row for row, the log-probability's two words included (bit for
    bit)."""
    bad = np.nonzero((got != want).any(axis=1))[0]
    assert bad.size == 0, (bad[:8], got[bad[:2], :12], want[bad[:2], :12])


# the polish's launch sizes (~1,300 pairs a call on E. coli, ~2,400 on the
# GRCh38 cut, at 150 bp), ragged warps and blocks, and the longest query
WALK_SHAPES = ([(1_300, 150), (2_400, 150), (1_000, 100), (1_000, 151)]
               + [(n, 150) for n in (1, 3, 5)] + [(64, 1), (64, 29),
                                                  (8, sw.MAX_LEN)])


@pytest.mark.cuda
@pytest.mark.parametrize("gs", ["bwa", "eland"])
@pytest.mark.parametrize("n,l", WALK_SHAPES)
def test_sw_walk_kernel_equals_plain(cuda_device, n, l, gs):
    from isaac_aligner_tpu_torch import synthetic
    from isaac_aligner_tpu_torch.align import gapped

    scoring = {"bwa": gapped.BWA, "eland": gapped.ELAND}[gs]
    q, db, ql = synthetic.sw_walk_pairs(np.random.default_rng(n + l), n, l)
    got, want = _walk_on(cuda_device, q, db, ql, scoring)
    _assert_walks_equal(got, want)
    if n >= 1_000:
        gapped_rows = (want[:, 2] & sw.WALK_GAPPED) != 0
        assert 0.3 < gapped_rows.mean() < 0.9


@pytest.mark.cuda
def test_sw_walk_kernel_ties_band_edges_and_bad_rows(cuda_device):
    """gfin ties (numpy's first largest), exits at d = 0 and 15, a quality
    past the tables and a walk leaving the band (both flagged bad, the row
    zero but for its flags), and a traceback built to the most runs."""
    from isaac_aligner_tpu_torch import synthetic
    from isaac_aligner_tpu_torch.align import gapped, quality

    gs = gapped.BWA
    l = 150
    q, db, ql = synthetic.sw_walk_pairs(np.random.default_rng(1), 900, l,
                                        offsets=[0, sw.BAND - 1])
    g, tb = sw.banded_sw_numpy_batch(q.astype(np.int32), db.astype(np.int32),
                                     gs.sw_scores())
    exit_d = g.argmax(axis=1)
    assert (exit_d[0:600:2] == 0).mean() > 0.3
    assert (exit_d[1:600:2] == sw.BAND - 1).mean() > 0.3
    g = g.copy()
    g[600:700] = 0.0                            # every d ties: exit 0
    g[700:800] = -90.0
    g[700:800, 4] = g[700:800, 11] = -1.0       # exit 4
    tb = tb.copy()
    tb[800:850] = synthetic.worst_case_walk_tb(l)
    g[800:850] = 0.0
    g[800:850, sw.BAND - 1] = 1.0
    got, want = _walk_on(cuda_device, q, db, ql, gs, g, tb)
    _assert_walks_equal(got, want)
    assert (got[800:850, 1] > 2 * l - 10).all()
    assert (got[:, 1] <= sw.walk_runs(l)).all()

    # a quality past the tables on gapped rows
    k = np.nonzero(want[:800, 2] == sw.WALK_GAPPED)[0][:5]
    ql = ql.copy()
    ql[k] = quality.MAX_Q
    # a walk that leaves the band: G at (l-1, 0) steps to E, which steps
    # to d = -1 (banded_sw never writes this code: E is NEG at d = 0)
    tb[850] = 0
    tb[850, (l - 1) // sw.TB_PACK, 0] = 1 << (6 * ((l - 1) % sw.TB_PACK))
    g[850] = 0.0
    got2, _ = _walk_on(cuda_device, q, db, ql, gs, g, tb)
    bad = np.r_[k, 850]
    assert (got2[bad, 2] == sw.WALK_BAD).all()
    assert not np.delete(got2[bad], 2, axis=1).any()
    keep = np.setdiff1d(np.arange(900), bad)
    _assert_walks_equal(got2[keep], want[keep])


@pytest.mark.cuda
def test_polish_gapped_card_equals_cpu(cuda_device, monkeypatch):
    """polish_gapped on the card leaves the same res as on the CPU, on both
    ends of a paired batch (cigar, start, mismatches, edit distance,
    float64-derived log_prob, mapq and frag_score) with the same
    sw_accepted; one sw_walk launch per banded_sw launch, and no per-pair
    Python walk or rescore."""
    import copy
    import types

    from isaac_aligner_tpu_torch import synthetic
    from isaac_aligner_tpu_torch.align import gapped
    from isaac_aligner_tpu_torch.align.pipeline import AlignConfig

    rng = np.random.default_rng(11)
    genome = synthetic.make_genome(rng, 300_000, families=((600, 20, 0.02),),
                                   n_island=(150_000, 500))
    index = types.SimpleNamespace(genome=genome)
    cfg = AlignConfig(seed_len=32, seed_offsets=(0,))
    res, ends = synthetic.polish_batch(rng, genome, 4_096, read_len=150)
    out = {}
    for dev in ("cpu", cuda_device):
        r = copy.deepcopy(res)
        tally = types.SimpleNamespace(sw_accepted=0)
        launches = (sw.banded_sw.launches, sw.sw_walk.launches)
        with monkeypatch.context() as m:
            if dev != "cpu":
                def host_walk(*a, **k):
                    raise AssertionError("per-pair host walk on the card")
                m.setattr(sw, "traceback", host_walk)
                m.setattr(sw, "_walk_rescore", host_walk)
                m.setattr(gapped, "rescore_cigar", host_walk)
            pairs = sum(gapped.polish_gapped(index, cfg, r, bases, dev, sfx,
                                             quals=quals, tally=tally)
                        for sfx, (bases, quals) in ends.items())
        out[str(dev)] = (r, pairs, tally.sw_accepted,
                         sw.banded_sw.launches - launches[0],
                         sw.sw_walk.launches - launches[1])
    (cpu, p_c, a_c, b_c, w_c), (card, p_g, a_g, b_g, w_g) = out.values()
    assert (p_g, a_g) == (p_c, a_c) and 0 < a_c < p_c
    assert (b_c, w_c) == (0, 0) and b_g == w_g == 2
    assert cpu.keys() == card.keys()
    for key in cpu:
        if isinstance(cpu[key], list):
            assert cpu[key] == card[key], key
        else:
            np.testing.assert_array_equal(cpu[key], card[key], err_msg=key)


@pytest.mark.cuda
def test_paired_aligner_card_equals_cpu(cuda_device):
    """The paired library path on the card against the CPU: TLS learned
    equal, and the records' core fields equal (MAPQ: floor flips only),
    with the banded SW kernel launched for both ends' polish."""
    from isaac_aligner_tpu_torch import synthetic
    from isaac_aligner_tpu_torch.aligner import PairedAligner
    from isaac_aligner_tpu_torch.index.build import build_index
    from isaac_aligner_tpu_torch.io.fastq import ReadBatch

    rng = np.random.default_rng(3)
    genome = synthetic.make_genome(rng, 250_000, families=((600, 10, 0.02),),
                                   n_island=(150_000, 500))
    index = build_index(genome, seed_len=32)
    sp = synthetic.make_pairs(rng, genome.codes, 1024)
    names = [f"t{i}" for i in range(1024)]

    def batches():
        return tuple(ReadBatch(names=names, bases=b.copy(),
                               quals=np.full(b.shape, 30, np.uint8),
                               lengths=np.full(1024, 100, np.int32))
                     for b in (sp.bases1, sp.bases2))

    out = []
    for dev in (cuda_device, "cpu"):
        al = PairedAligner.create(index, read_len=100, device=dev)
        tls = al.learn_tls([batches()])
        if al.device.type == "cuda":
            # the batch's first sight runs eagerly and its second captures
            # it: the compared batch is a replay of its CUDA graph
            for _ in range(2):
                al.align_to_sam(*batches())
        before = sw.banded_sw.launches, sw.sw_walk.launches
        recs = al.align_to_sam(*batches())
        out.append((tls, recs, sw.banded_sw.launches - before[0],
                    sw.sw_walk.launches - before[1]))
        if al.device.type == "cuda":
            assert (al.eager_dispatches, al.graph_captures,
                    al.graph_replays) == (1, 1, 1)
    (tls_g, gpu, n_g, w_g), (tls_c, cpu, n_c, w_c) = out
    assert tls_g == tls_c and {tls_g.best0, tls_g.best1} == {1, 6}
    assert n_g > 0 and n_c == 0
    assert w_g == n_g and w_c == 0

    def core(r):
        return (r.qname, r.flag, r.pos, r.cigar, r.tags.get("NM"), r.rnext,
                r.pnext, r.tlen)
    assert [core(r) for r in gpu] == [core(r) for r in cpu]
    dq = np.array([abs(g.mapq - c.mapq) for g, c in zip(gpu, cpu)])
    assert dq.max() <= 1 and (dq > 0).sum() <= 0.005 * len(dq)
    proper = np.array([r.flag & 0x2 != 0 for r in gpu])
    assert proper.mean() > 0.9


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 32, 64])
def test_neighbor_annotation_card_equals_cpu(cuda_device, k):
    from isaac_aligner_tpu_torch import synthetic
    from isaac_aligner_tpu_torch.index.neighbors_device import \
        find_neighbors_device

    planes = synthetic.planted_kmers(np.random.default_rng(k), 20_000, k)
    got = find_neighbors_device(planes, k, device=cuda_device)
    want = find_neighbors_device(planes, k, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 5_000


def _grouped_fixture():
    from isaac_aligner_tpu_torch import synthetic
    from isaac_aligner_tpu_torch.index.build import build_index
    from isaac_aligner_tpu_torch.index.groups import (split_genome_groups,
                                                      subset_genome)

    rng = np.random.default_rng(5)
    genome = synthetic.make_genome(rng, 400_000, families=((600, 20, 0.02),),
                                   n_island=(250_000, 500), n_contigs=4)
    indexes = [build_index(subset_genome(genome, names), seed_len=32,
                           annotate_neighbors=True, device="cpu")
               for names in split_genome_groups(genome.contigs, 200_000)]
    return genome, indexes, synthetic.make_pairs(rng, genome.codes, 1024,
                                                 far_min=50_000)


@pytest.mark.cuda
def test_grouped_aligner_card_equals_cpu(cuda_device):
    """Two contig groups: the paired multi-index aligner on the card
    against the CPU, resident and group-major, with the banded SW kernel
    launched at most once per end per group."""
    from isaac_aligner_tpu_torch.align.pairs import TlsStatic
    from isaac_aligner_tpu_torch.io.fastq import ReadBatch
    from isaac_aligner_tpu_torch.parallel.multi_index import \
        MultiIndexPairedAligner

    _genome, indexes, sp = _grouped_fixture()
    assert len(indexes) == 2
    names = [f"t{i}" for i in range(1024)]

    def batches():
        return tuple(ReadBatch(names=names, bases=b.copy(),
                               quals=np.full(b.shape, 30, np.uint8),
                               lengths=np.full(1024, 100, np.int32))
                     for b in (sp.bases1, sp.bases2))

    tls = TlsStatic(min=150, max=500, mate_min=150, mate_max=500, best0=1,
                    best1=6, median=300)
    out = {}
    for dev, gm in ((cuda_device, False), (cuda_device, True), ("cpu", False)):
        al = MultiIndexPairedAligner.create(indexes, read_len=100,
                                            device=dev, group_major=gm)
        al.tls = tls
        before = sw.banded_sw.launches
        res = [r for _b, r in al.align_results_many([batches()])][0]
        out[(str(dev), gm)] = (res, sw.banded_sw.launches - before)
    (g, n_g), (gm_res, n_gm), (c, n_c) = out.values()
    assert n_g == n_gm and 2 <= n_g <= 4 and n_c == 0
    for k in ("aligned_1", "aligned_2", "start_1", "start_2", "reverse_1",
              "reverse_2", "proper_pair", "edit_distance_1",
              "edit_distance_2"):
        np.testing.assert_array_equal(g[k], c[k], err_msg=k)
        np.testing.assert_array_equal(gm_res[k], g[k], err_msg=k)
    assert g["cigar_1"] == c["cigar_1"] and g["cigar_2"] == c["cigar_2"]
    for k in ("frag_score_1", "frag_score_2", "template_score"):
        d = np.abs(g[k].astype(np.int64) - c[k].astype(np.int64))
        assert d.max() <= 1 and (d > 0).sum() <= 0.005 * d.size, k
    assert g["proper_pair"].mean() > 0.9


#: two TLS models of the graph tests' pairs (TlsStatic fields; a
#: per-tile hint stands for the second)
_TLS_A = dict(min=150, max=500, mate_min=150, mate_max=500, best0=1,
              best1=6, median=300)
GRAPH_TLS = (_TLS_A, dict(_TLS_A, min=180, max=450, mate_min=180,
                          mate_max=450, median=310))


@pytest.mark.cuda
@pytest.mark.parametrize("driver", ["single", "paired", "grouped"])
def test_graph_replay_bit_equal_to_eager(cuda_device, driver):
    """Nine batches of other reads each through a driver whose device
    programs are captured and replayed as CUDA graphs, against the same
    driver's eager program (its graphs dropped before every batch, so each
    is a first sight): every key of every output dict bit-equal, over a
    change of shape and, paired, a change of TLS.  Per group and key the
    first sight is eager, the second a capture and the rest replays; the
    two groups of the multi-index driver share one pool."""
    from isaac_aligner_tpu_torch.aligner import Aligner, PairedAligner
    from isaac_aligner_tpu_torch.align.pairs import TlsStatic
    from isaac_aligner_tpu_torch.index.build import build_index
    from isaac_aligner_tpu_torch.io.fastq import ReadBatch
    from isaac_aligner_tpu_torch.parallel.multi_index import \
        MultiIndexPairedAligner

    genome, indexes, sp = _grouped_fixture()
    n = sp.bases1.shape[0]
    quals = np.random.default_rng(11).integers(
        2, 41, (2,) + sp.bases1.shape).astype(np.uint8)
    whole = build_index(genome, seed_len=32) if driver != "grouped" else None
    tls = [TlsStatic(**t) for t in GRAPH_TLS]

    def make():
        if driver == "grouped":
            return MultiIndexPairedAligner.create(indexes, read_len=100,
                                                  device=cuda_device)
        cls = Aligner if driver == "single" else PairedAligner
        return cls.create(whole, read_len=100, device=cuda_device)

    def batch(k, rows):
        idx = (np.arange(rows) + 97 * k) % n
        ends = tuple(ReadBatch(names=[f"t{i}" for i in idx],
                               bases=b[idx].copy(), quals=q[idx].copy(),
                               lengths=np.full(rows, 100, np.int32))
                     for b, q in ((sp.bases1, quals[0]),
                                  (sp.bases2, quals[1])))
        return ends[:1] if driver == "single" else ends

    def dispatch(al, inputs) -> list[dict]:
        if driver == "grouped":
            return [p[0] for p in al._dispatch_all(*inputs)]
        return [al._dispatch(*inputs)[0]]

    al, ref = make(), make()
    groups = getattr(al, "aligners", [al])
    if driver == "grouped":
        assert groups[0].graphs.pool is groups[1].graphs.pool
    # (rows, TLS model) of each batch: one key's four sights, a change of
    # shape, the key again, a change of TLS (a new key when paired)
    plan = [(n, 0)] * 4 + [(n - 256, 0), (n, 0)] + [(n, 1)] * 3
    for k, (rows, t) in enumerate(plan):
        inputs = batch(k, rows)
        if driver != "single":
            al.tls = ref.tls = tls[t]
        got = dispatch(al, inputs)
        for a in getattr(ref, "aligners", [ref]):
            a.graphs.clear()
        want = dispatch(ref, inputs)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for key in w:
                assert torch.equal(g[key], w[key]), (k, key)
    # single-end: the first key's 8 sights and the other shape's one;
    # paired: the first key's 5, the other shape's 1, the other TLS's 3
    expect = (2, 1, 6) if driver == "single" else (3, 2, 4)
    for a in groups:
        assert (a.eager_dispatches, a.graph_captures, a.graph_replays) \
            == expect
    assert (al.eager_dispatches, al.graph_captures, al.graph_replays) == \
        tuple(len(groups) * e for e in expect)
    assert ref.graph_replays == ref.graph_captures == 0


@pytest.mark.cuda
def test_release_device_returns_memory(cuda_device):
    """Each group's planes come and go: memory_allocated is back at its
    baseline after every release_device."""
    from isaac_aligner_tpu_torch.aligner import Aligner
    from isaac_aligner_tpu_torch.align.pipeline import plane_bytes

    _genome, indexes, _sp = _grouped_fixture()
    aligners = [Aligner.create(ix, read_len=100, device=cuda_device,
                               defer_upload=True) for ix in indexes]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda_device)
    for al, ix in zip(aligners, indexes):
        al.ensure_uploaded()
        held = torch.cuda.memory_allocated(cuda_device) - base
        assert held >= plane_bytes(ix) - 4096, (held, plane_bytes(ix))
        al.release_device()
        assert al.arrays is None
        assert torch.cuda.memory_allocated(cuda_device) == base


#: the seed-stage options, each alone: (index seed length, AlignConfig
#: fields, paired)
SEED_OPTIONS = {
    "seed64_over_32mer_index": (32, {"seed_len": 64}, False),
    "index64": (64, {"seed_len": 64}, False),
    "neighbors": (32, {"neighborhood_size_threshold": 100}, False),
    "neighbors_seed16": (16, {"seed_len": 16,
                              "neighborhood_size_threshold": 100}, False),
    "scatter_se": (32, {"scatter_repeats": True}, False),
    "scatter_pe": (32, {"scatter_repeats": True}, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("option", list(SEED_OPTIONS))
def test_seed_options_card_equals_cpu(cuda_device, option):
    """64-mer seeds (over a 32-mer index and a 64-mer index), the neighbor
    pass (at k=32 and off at k=16) and --scatter-repeats (single-end and
    paired) on the card against the CPU: the records' core fields equal
    (MAPQ: floor flips only), the banded SW kernel launched on the card."""
    from isaac_aligner_tpu_torch import synthetic
    from isaac_aligner_tpu_torch.aligner import Aligner, PairedAligner
    from isaac_aligner_tpu_torch.align.pairs import TlsStatic
    from isaac_aligner_tpu_torch.align.pipeline import (AlignConfig,
                                                        default_seed_offsets)
    from isaac_aligner_tpu_torch.index.build import build_index
    from isaac_aligner_tpu_torch.io.fastq import ReadBatch

    k, fields, paired = SEED_OPTIONS[option]
    rng = np.random.default_rng(9)
    # exact repeat copies give exact score ties for --scatter-repeats
    genome = synthetic.make_genome(rng, 250_000,
                                   families=((600, 10, 0.0), (400, 12, 0.02)),
                                   n_island=(150_000, 500))
    index = build_index(genome, seed_len=k)
    seed_len = fields.get("seed_len", 32)
    cfg = AlignConfig(**{"seed_offsets": default_seed_offsets(100, seed_len),
                         **fields})
    n = 2048
    if paired:
        sp = synthetic.make_pairs(rng, genome.codes, n)
        reads = (sp.bases1, sp.bases2)
    else:
        reads = (synthetic.make_reads(rng, genome.codes, n).bases,)
    names = [f"t{i}" for i in range(n)]

    def batches():
        return tuple(ReadBatch(names=names, bases=b.copy(),
                               quals=np.full(b.shape, 30, np.uint8),
                               lengths=np.full(n, 100, np.int32))
                     for b in reads)

    out = []
    for dev in (cuda_device, "cpu"):
        if paired:
            al = PairedAligner.create(index, read_len=100, cfg=cfg, device=dev)
            al.tls = TlsStatic(min=150, max=500, mate_min=150, mate_max=500,
                               best0=1, best1=6, median=300)
        else:
            al = Aligner.create(index, read_len=100, cfg=cfg, device=dev)
        before = sw.banded_sw.launches
        recs = al.align_to_sam(*batches())
        out.append((recs, sw.banded_sw.launches - before))
    (gpu, n_g), (cpu, n_c) = out
    assert n_g > 0 and n_c == 0

    def core(r):
        return (r.qname, r.flag, r.pos, r.cigar, r.tags.get("NM"), r.rnext,
                r.pnext, r.tlen)
    assert [core(r) for r in gpu] == [core(r) for r in cpu]
    dq = np.array([abs(g.mapq - c.mapq) for g, c in zip(gpu, cpu)])
    assert dq.max() <= 1 and (dq > 0).sum() <= 0.005 * len(dq)
    assert np.mean([r.is_mapped for r in gpu]) > 0.7


def _spmd_fixture(n=1024):
    from isaac_aligner_tpu_torch import synthetic
    from isaac_aligner_tpu_torch.index.build import build_index

    rng = np.random.default_rng(13)
    genome = synthetic.make_genome(rng, 250_000, families=((600, 10, 0.02),),
                                   n_island=(150_000, 500))
    index = build_index(genome, seed_len=32)
    sp = synthetic.make_pairs(rng, genome.codes, n)
    return index, sp


def _spmd_batches(sp, paired: bool):
    from isaac_aligner_tpu_torch.io.fastq import ReadBatch

    n = sp.bases1.shape[0]
    names = [f"t{i}" for i in range(n)]
    reads = (sp.bases1, sp.bases2) if paired else (sp.bases1,)
    return tuple(ReadBatch(names=names, bases=b.copy(),
                           quals=np.full(b.shape, 30, np.uint8),
                           lengths=np.full(n, 100, np.int32)) for b in reads)


SPMD_KEYS = {
    False: ("aligned", "start", "reverse", "edit_distance", "mismatches"),
    True: ("aligned_1", "aligned_2", "start_1", "start_2", "reverse_1",
           "reverse_2", "proper_pair", "template_length", "edit_distance_1",
           "edit_distance_2")}
SPMD_SCORES = {False: ("mapq",),
               True: ("frag_score_1", "frag_score_2", "template_score")}


@pytest.mark.cuda
@pytest.mark.parametrize("program", ["single", "paired", "genome_sharded"])
def test_sharded_programs_card_equal_cpu(cuda_device, program):
    """The sharded drivers over meshes of cuda:0 entries against the same
    meshes of cpu entries: integer fields and CIGARs equal, scores to floor
    flips, and the banded SW kernel launched on the card only.  (2, 2)
    meshes for the index-sharded programs, (1, 2) for the genome-sharded
    paired one."""
    from isaac_aligner_tpu_torch.align.pairs import TlsStatic
    from isaac_aligner_tpu_torch.parallel.sharded import Mesh
    from isaac_aligner_tpu_torch.parallel.sharded_aligner import (
        ShardedAligner, ShardedPairedAligner)

    index, sp = _spmd_fixture()
    paired = program != "single"
    gs = program == "genome_sharded"
    data, shard = (1, 2) if gs else (2, 2)
    tls = TlsStatic(min=150, max=500, mate_min=150, mate_max=500, best0=1,
                    best1=6, median=300)
    out = []
    for dev in (torch.device("cuda", 0), torch.device("cpu")):
        mesh = Mesh([[dev] * shard for _ in range(data)])
        assert mesh.shape == {"data": data, "shard": shard}
        cls = ShardedPairedAligner if paired else ShardedAligner
        al = cls.create_sharded(index, mesh=mesh, read_len=100,
                                genome_sharded=gs)
        if paired:
            al.tls = tls
        before = sw.banded_sw.launches
        res = al.align_batch_arrays(*_spmd_batches(sp, paired))
        out.append((res, sw.banded_sw.launches - before))
    (g, n_g), (c, n_c) = out
    assert n_g > 0 and n_c == 0
    for k in SPMD_KEYS[paired]:
        np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(c[k]),
                                      err_msg=k)
    for sfx in ("_1", "_2") if paired else ("",):
        assert g["cigar" + sfx] == c["cigar" + sfx]
    for k in SPMD_SCORES[paired]:
        d = np.abs(np.asarray(g[k], np.int64) - np.asarray(c[k], np.int64))
        assert d.max() <= 1 and (d > 0).sum() <= 0.005 * d.size, k
    aligned = g["aligned_1"] if paired else g["aligned"]
    assert np.mean(aligned) > 0.9
    if paired:
        assert np.mean(g["proper_pair"]) > 0.85


@pytest.mark.cuda
def test_collective_dedup_card_equals_cpu(cuda_device):
    """collective_dedup over four cuda:0 entries equals four cpu entries,
    with no overflow at the default capacity."""
    from isaac_aligner_tpu_torch.parallel.sharded import collective_dedup

    rng = np.random.default_rng(17)
    n = 65_536
    args = (rng.integers(0, 4_000, n).astype(np.int64) * 2,
            rng.integers(0, 4_000, n).astype(np.int64) * 2,
            rng.integers(0, 1 << 40, n).astype(np.int64),
            rng.integers(0, 1 << 40, n).astype(np.int64),
            rng.integers(-1, 4, n).astype(np.int64),
            np.zeros(n, np.int64))
    got, over_g = collective_dedup([cuda_device] * 4, *args)
    want, over_c = collective_dedup(["cpu"] * 4, *args)
    np.testing.assert_array_equal(got, want)
    assert over_g.sum() == over_c.sum() == 0
    assert 0 < got.sum() < n


def _input_fixture(tmp: Path) -> dict:
    """A 250 kbp genome's index, 1,024 pairs as a demultiplexed run folder
    (two tiles, two samples, a sample sheet) and as FASTQs with a barcode
    FASTQ and a per-barcode sheet (sample b "unmapped")."""
    from isaac_aligner_tpu_torch import synthetic
    from isaac_aligner_tpu_torch.index.build import build_index

    rng = np.random.default_rng(8)
    genome = synthetic.make_genome(rng, 250_000, families=((600, 10, 0.02),),
                                   n_island=(150_000, 500))
    build_index(genome, seed_len=32).save(tmp / "idx")
    sp = synthetic.make_pairs(rng, genome.codes, 1024)
    barcodes = ["ACGTACGT", "TGCATGCA"]
    index, _s, _m = synthetic.barcode_reads(rng, 1024, barcodes, 0.05, 0.05)
    synthetic.write_pair_run_folder(
        tmp / "run", sp.bases1, sp.bases2, index,
        [(1, "per_cycle", [1101]), (2, "bgzf", [1101])],
        pf=rng.random(1024) > 0.05, clocs=True)
    (tmp / "sheet.csv").write_text(
        "barcode,sample\nACGTACGT,a\nTGCATGCA,b\n")
    (tmp / "per_barcode.csv").write_text(
        f"barcode,sample,reference\nACGTACGT,a,{tmp / 'idx'}\n"
        f"TGCATGCA,b,unmapped\n")
    letters = np.frombuffer(b"ACGTN", np.uint8)
    for name, codes in (("r1", sp.bases1), ("r2", sp.bases2), ("i1", index)):
        with open(tmp / f"{name}.fq", "w") as f:
            for i, row in enumerate(letters[codes]):
                f.write(f"@t{i}\n{row.tobytes().decode()}\n+\n"
                        f"{'?' * row.size}\n")
    return {"samples": ["a", "b", "unknown"]}


def _core(out: Path, samples) -> tuple[dict, dict]:
    """{(qname, read): core fields with RG and BC} and MAPQs of every
    sample's sorted.bam (or out/sorted.bam without samples)."""
    from isaac_aligner_tpu_torch.io.bam import read_bam

    core, mapq = {}, {}
    for s in samples or [""]:
        path = out / s / "sorted.bam"
        if not path.exists():
            continue
        for r in read_bam(path)[2]:
            key = (r.qname, r.flag & 0xC0)
            core[key] = (r.flag, r.pos, r.cigar, r.tags.get("NM"), r.rnext,
                         r.pnext, r.tlen, r.tags.get("RG"), r.tags.get("BC"))
            mapq[key] = r.mapq
    return core, mapq


def _workflow_card_equals_cpu(tmp: Path, samples, **opts) -> dict:
    """The workflow (`opts`) on the card and on the CPU: the same saved
    TLS (and per-tile models) and core fields, MAPQ floor flips only, the
    kernel launched on the card.  Returns the card run's state."""
    import json

    from isaac_aligner_tpu_torch.workflow.align import (AlignWorkflow,
                                                        WorkflowOptions)

    runs = {}
    for dev in ("cuda", "cpu"):
        out = tmp / f"out_{dev}"
        before = sw.banded_sw.launches
        AlignWorkflow(WorkflowOptions(
            reference=str(tmp / "idx"), output_dir=str(out), batch_size=512,
            device=dev, **opts)).run()
        state_file = out / "Temp" / "AlignerState.json"
        state = json.loads(state_file.read_text()) if state_file.exists() \
            else {}
        runs[dev] = (state, *_core(out, samples),
                     sw.banded_sw.launches - before)
    (st_g, core_g, mq_g, n_g), (st_c, core_c, mq_c, n_c) = runs.values()
    assert n_g > 0 and n_c == 0
    assert (st_g.get("tls"), st_g.get("tls_by_tile")) == \
        (st_c.get("tls"), st_c.get("tls_by_tile"))
    assert core_g and core_g == core_c
    dq = np.array([abs(mq_g[k] - mq_c[k]) for k in mq_g])
    assert dq.max() <= 1 and (dq > 0).sum() <= 0.005 * len(dq)
    return st_g


@pytest.mark.cuda
def test_run_folder_workflow_card_equals_cpu(cuda_device, tmp_path):
    fx = _input_fixture(tmp_path)
    state = _workflow_card_equals_cpu(
        tmp_path, fx["samples"], run_folder=str(tmp_path / "run"),
        sample_sheet=str(tmp_path / "sheet.csv"), per_tile_tls=True,
        bam_exclude_tags="none")
    assert set(state["tls_by_tile"]) == {"1:1101", "2:1101"}


@pytest.mark.cuda
def test_bam_input_workflow_card_equals_cpu(cuda_device, tmp_path):
    from isaac_aligner_tpu_torch.workflow.align import (AlignWorkflow,
                                                        WorkflowOptions)

    _input_fixture(tmp_path)
    AlignWorkflow(WorkflowOptions(
        reference=str(tmp_path / "idx"), output_dir=str(tmp_path / "src"),
        fastq1=str(tmp_path / "r1.fq"), fastq2=str(tmp_path / "r2.fq"),
        batch_size=512, device="cpu")).run()
    _workflow_card_equals_cpu(
        tmp_path, None, bam_input=str(tmp_path / "src" / "sorted.bam"))


@pytest.mark.cuda
def test_per_barcode_workflow_card_equals_cpu(cuda_device, tmp_path):
    """The per-barcode driver from FASTQ plus a barcode FASTQ on both
    devices, and the card's allocated memory back at its baseline after
    each aligning sub-workflow."""
    from isaac_aligner_tpu_torch.workflow.per_barcode import PerBarcodeDriver
    from isaac_aligner_tpu_torch.workflow.align import WorkflowOptions

    fx = _input_fixture(tmp_path)
    kw = dict(fastq1=str(tmp_path / "r1.fq"), fastq2=str(tmp_path / "r2.fq"),
              barcode_fastq=str(tmp_path / "i1.fq"),
              sample_sheet=str(tmp_path / "per_barcode.csv"))
    _workflow_card_equals_cpu(tmp_path, fx["samples"], **kw)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    driver = PerBarcodeDriver(WorkflowOptions(
        reference=str(tmp_path / "idx"), output_dir=str(tmp_path / "again"),
        batch_size=512, device="cuda", **kw))
    driver.run()
    assert driver.device_bytes == {"a": base, "unknown": base}
