"""The port's paired-end device code and host passes vs the JAX package's,
on the same numpy inputs on the CPU: score_end, resolve_pairs and
paired_from_ends on random end dicts (ties, all-invalid rows, cross-contig
candidates, dodgy rows), mate_window_dynamic for every model pair,
rescue_shadows at windows 256 and 512 (windows off the genome's ends and
over an N island), align_paired_batch with trim and clip on, and the host
copies: the TLS learner, clip_semialigned, clip_overlapping and
from_paired_result."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaac_aligner_tpu import aligner as jaligner
from isaac_aligner_tpu.align import clippers as jclippers
from isaac_aligner_tpu.align import pairs as jpairs
from isaac_aligner_tpu.align import pipeline as jpipe
from isaac_aligner_tpu.align import tls as jtls
from isaac_aligner_tpu.build import storage as jstorage
from isaac_aligner_tpu.index.build import build_index
from isaac_aligner_tpu.io import fastq as jfastq
from isaac_aligner_tpu_torch.align import clippers, pairs, tls
from isaac_aligner_tpu_torch.align import pipeline as tpipe
from isaac_aligner_tpu_torch.build import storage
from isaac_aligner_tpu_torch.io import fastq

from test_torch_host import to_port_index
from test_torch_paired import L, _revcomp, pair_genome, pair_rows

TLS = dict(min=210, max=390, mate_min=210, mate_max=390, best0=1, best1=6,
           median=300)


@pytest.fixture(scope="module")
def env():
    """JAX and port index planes and configs of the paired fixture."""
    genome = pair_genome()
    jidx = build_index(genome, seed_len=32)
    jcfg = jaligner._with_bucket_log2(
        jpipe.AlignConfig(seed_len=32,
                          seed_offsets=jpipe.default_seed_offsets(L, 32)),
        jidx)
    tcfg = tpipe.AlignConfig(**dataclasses.asdict(jcfg))
    return dict(genome=genome, jidx=jidx, jcfg=jcfg, tcfg=tcfg,
                jarr=jpipe.prepare_index(jidx, upload_codes=False),
                tarr=tpipe.prepare_index(to_port_index(jidx), "cpu"),
                rows=pair_rows(genome.codes))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


#: absolute tolerances beside rtol 1e-5 (f32 reduction order): the
#: non-best masses are a difference of two sums on the scale where the best
#: mass is 1; the rescue's raw total_prob reaches f32 subnormals, which XLA
#: on the CPU flushes to zero (ROADMAP section C)
ATOL = {"others_sum_1": 1e-5, "others_sum_2": 1e-5,
        "total_prob": np.finfo(np.float32).tiny}


def _assert_dicts_equal(t: dict, j: dict, floats=(), skip=()):
    assert set(t) == set(j)
    for k in j:
        if k in skip or k == "finder_stats":
            continue
        a, b = _np(t[k]), _np(j[k])
        if k in floats:
            fin = np.isfinite(b)
            np.testing.assert_array_equal(np.isfinite(a), fin, k)
            np.testing.assert_allclose(a[fin], b[fin], rtol=1e-5,
                                       atol=ATOL.get(k, 0.0), err_msg=k)
        else:
            np.testing.assert_array_equal(a, b, k)


def _ends(env):
    rows = env["rows"]
    b1 = np.stack([r[1] for r in rows]); q1 = np.stack([r[3] for r in rows])
    b2 = np.stack([r[2] for r in rows]); q2 = np.stack([r[4] for r in rows])
    return b1, q1, b2, q2


_score_end_jit = jax.jit(jpipe.score_end, static_argnames=("cfg", "find_fn",
                                                           "score_fn"))


def test_score_end_fields_equal_jax(env):
    b1, q1, _, _ = _ends(env)
    j = _score_end_jit(env["jarr"], env["jcfg"], jnp.asarray(b1),
                       jnp.asarray(q1))
    t = tpipe.score_end(env["tarr"], env["tcfg"], torch.from_numpy(b1),
                        torch.from_numpy(q1))
    _assert_dicts_equal(t, j, floats=("log_prob",))
    for k in j["finder_stats"]:
        assert int(t["finder_stats"][k]) == int(j["finder_stats"][k]), k
    assert _np(t["valid"]).any(axis=1).mean() > 0.9


def random_ends(seed: int, b: int = 96, c: int = 8):
    """Two random end dicts (numpy): duplicated candidate starts and log
    probs (ties), rows with no valid candidate, two contigs, dodgy rows,
    and pair geometries around the TLS window."""
    rng = np.random.default_rng(seed)
    ends = []
    base = rng.integers(1_000, 50_000, b)
    for e in range(2):
        start = base[:, None] + rng.integers(-400, 400, (b, c))
        if e == 1:
            start = start + rng.choice([0, 180, 300], (b, 1))
        start[:, 1] = start[:, 0]                   # duplicated starts
        orient = rng.integers(0, 2, (b, c)).astype(np.int32)
        valid = rng.random((b, c)) < 0.6
        valid[3 * e::11] = False                    # all-invalid rows
        mism = rng.integers(0, 4, (b, c)).astype(np.int32)
        mism[::5] = 0
        lp = (-mism * 4.0 - rng.random((b, c)) * 2).astype(np.float32)
        lp[::3, 2] = lp[::3, 3]                     # equal log probs
        mism[::3, 2] = mism[::3, 3]
        lp = np.where(valid, lp, -np.inf).astype(np.float32)
        cid = np.where(rng.random((b, c)) < 0.15, 1, 0)
        ends.append(dict(
            start=start.astype(np.int32), orient=orient, valid=valid,
            cid=np.where(valid, cid, -1).astype(np.int32), log_prob=lp,
            sw_score=mism, mismatches=mism,
            edit=(mism + rng.integers(0, 2, (b, c))).astype(np.int32),
            obs_len=np.full((b, c), L, np.int32),
            well_anchored=rng.random((b, c)) < 0.9,
            dodgy=rng.random(b) < 0.05,
            num_candidates=valid.sum(axis=1).astype(np.int32)))
    return ends


def _as(d, mod):
    if mod == "jax":
        return {k: jnp.asarray(v) for k, v in d.items()}
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in d.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resolve_pairs_equals_jax(env, seed):
    e1, e2 = random_ends(seed)
    log_rog = jpipe.quality.log_rest_of_genome_correction(4_600_000, 2 * L)
    j = jpairs.resolve_pairs(env["jcfg"], jpairs.TlsStatic(**TLS),
                             _as(e1, "jax"), _as(e2, "jax"), log_rog)
    t = pairs.resolve_pairs(env["tcfg"], pairs.TlsStatic(**TLS),
                            _as(e1, "t"), _as(e2, "t"), log_rog)
    cap = env["jcfg"].mapq_cap
    # the raw JAX score may be an int32-cast inf; both clip to the cap
    jscore = np.clip(_np(j.pop("template_score")), -1, cap)
    np.testing.assert_array_equal(_np(t.pop("template_score")), jscore)
    _assert_dicts_equal(t, j, floats=("total_prob", "best_lp", "log_scale"))
    assert _np(j["resolved"]).any() and not _np(j["resolved"]).all()
    assert (jscore == cap).any()


@pytest.mark.parametrize("dodgy_unaligned", [False, True])
@pytest.mark.parametrize("seed", [3, 4])
def test_paired_from_ends_equals_jax(env, seed, dodgy_unaligned):
    e1, e2 = random_ends(seed)
    jcfg = dataclasses.replace(env["jcfg"], dodgy_unaligned=dodgy_unaligned,
                               dodgy_mapq=3)
    tcfg = tpipe.AlignConfig(**dataclasses.asdict(jcfg))
    j = jpairs.paired_from_ends(4_600_000, L, L, jcfg,
                                jpairs.TlsStatic(**TLS), _as(e1, "jax"),
                                _as(e2, "jax"))
    t = pairs.paired_from_ends(4_600_000, L, L, tcfg,
                               pairs.TlsStatic(**TLS), _as(e1, "t"),
                               _as(e2, "t"))
    floats = ("pair_total_prob", "pair_best_lp", "pair_log_scale",
              "others_sum_1", "others_sum_2", "log_scale_1", "log_scale_2",
              "log_prob_1", "log_prob_2")
    _assert_dicts_equal(t, j, floats=floats,
                        skip=("frag_score_1", "frag_score_2",
                              "template_score"))
    for k in ("frag_score_1", "frag_score_2", "template_score"):
        d = np.abs(_np(t[k]).astype(np.int64) - _np(j[k]))
        assert d.max() <= 1 and (d > 0).sum() <= 1, k
    assert _np(j["disjoined"]).any() and _np(j["shadow_1"]).any()


def test_mate_window_dynamic_equals_jax_and_host_model():
    read_lengths = (100, 90)
    rev = np.array([False, True])
    for best0 in range(8):
        for best1 in range(8):
            t_ = pairs.TlsStatic(min=150, max=420, mate_min=140,
                                 mate_max=430, best0=best0, best1=best1,
                                 median=285)
            j_ = jpairs.TlsStatic(**dataclasses.asdict(t_))
            s = t_.to_stats()
            for read_index in (0, 1):
                got = [_np(x) for x in pairs.mate_window_dynamic(
                    t_, read_index, read_lengths, torch.from_numpy(rev))]
                want = [_np(x) for x in jpairs.mate_window_dynamic(
                    j_, read_index, read_lengths, jnp.asarray(rev))]
                for a, b in zip(got, want):
                    np.testing.assert_array_equal(a, b)
                for k, r in enumerate((False, True)):
                    assert got[0][k] == s.mate_min_position(
                        read_index, r, 0, read_lengths)
                    assert got[1][k] == s.mate_max_position(
                        read_index, r, 0, read_lengths)
                    assert bool(got[2][k]) == s.mate_orientation(read_index, r)


def _rescue_rows(genome):
    """(orphan_start, orphan_rev, shadow bases, quals) rows of read-1
    orphans: damaged and exact mates at the FRp geometry, windows hanging
    off chrA's start, off chrB's (the genome's) end, over the N island,
    across the contig boundary, and junk mates."""
    rng = np.random.default_rng(7)
    g = genome.codes
    gl = g.size
    rows = []
    for p in (2_000, 7_400, 11_800, 11_900, 15_700, 16_050):
        mate = _revcomp(g[p + 200:p + 300])
        dmg = mate.copy()
        dmg[::10] = (dmg[::10] + 1) % 4
        rows += [(p, False, mate), (p, False, dmg)]
    for p in (0, 30, 150):                     # off the genome start
        rows.append((p, True, g[max(p - 150, 0):max(p - 150, 0) + L]))
        rows.append((p, False, _revcomp(g[p + 200:p + 300])))
    for p in (gl - 100, gl - 250, gl - 400):   # off the genome end
        rows.append((p, False, rng.integers(0, 4, L).astype(np.uint8)))
        rows.append((p, True, g[p - 200:p - 100]))
    rows.append((5_000, False, np.full(L, 4, np.uint8)))
    bases = np.stack([r[2] for r in rows]).astype(np.uint8)
    quals = rng.integers(20, 41, bases.shape).astype(np.uint8)
    return (np.array([r[0] for r in rows], np.int32),
            np.array([r[1] for r in rows]), bases, quals)


@pytest.mark.parametrize("window", [256, 512])
@pytest.mark.parametrize("orphan_end", [1, 2])
def test_rescue_shadows_equals_jax(env, window, orphan_end):
    start, rev, bases, quals = _rescue_rows(env["genome"])
    t_ = dict(TLS)
    if window == 512:
        t_.update(min=150, max=560, mate_min=150, mate_max=560)
    j = jpairs.rescue_shadows(
        env["jarr"], env["jcfg"], jpairs.TlsStatic(**t_), orphan_end - 1,
        (L, L), jnp.asarray(start), jnp.asarray(rev), jnp.asarray(bases),
        jnp.asarray(quals), window)
    t = pairs.rescue_shadows(
        env["tarr"], env["tcfg"], pairs.TlsStatic(**t_), orphan_end - 1,
        (L, L), torch.from_numpy(start), torch.from_numpy(rev),
        torch.from_numpy(bases), torch.from_numpy(quals), window)
    _assert_dicts_equal(t, j, floats=("log_prob", "total_prob"),
                        skip=("score",))
    d = np.abs(_np(t["score"]).astype(np.int64) - _np(j["score"]))
    assert d.max() <= 1 and (d > 0).sum() <= 1
    if orphan_end == 1:
        assert _np(j["found"])[:12].all()


def test_rescue_on_a_genome_without_n(env):
    """The N-free path (no N-bit plane gather) gives the same result."""
    jcfg = dataclasses.replace(env["jcfg"], genome_has_n=False)
    tcfg = dataclasses.replace(env["tcfg"], genome_has_n=False)
    start, rev, bases, quals = _rescue_rows(env["genome"])
    args = (0, (L, L))
    j = jpairs.rescue_shadows(env["jarr"], jcfg, jpairs.TlsStatic(**TLS),
                              *args, jnp.asarray(start), jnp.asarray(rev),
                              jnp.asarray(bases), jnp.asarray(quals), 256)
    t = pairs.rescue_shadows(env["tarr"], tcfg, pairs.TlsStatic(**TLS),
                             *args, torch.from_numpy(start),
                             torch.from_numpy(rev), torch.from_numpy(bases),
                             torch.from_numpy(quals), 256)
    _assert_dicts_equal(t, j, floats=("log_prob", "total_prob"),
                        skip=("score",))


_paired_jit = jax.jit(jpairs.align_paired_batch,
                      static_argnames=("cfg", "find_fn", "score_fn",
                                       "clip_fn"))


def test_align_paired_batch_with_trim_and_clip_equals_jax(env):
    b1, q1, b2, q2 = _ends(env)
    q1 = q1.copy(); q2 = q2.copy()
    q1[::7, -20:] = 3                       # low-quality tails to trim
    tm1 = np.zeros(len(b1), np.int32); tm1[::9] = 6
    tm2 = np.zeros(len(b1), np.int32); tm2[1::9] = 4
    jcfg = dataclasses.replace(env["jcfg"], quality_trim_cutoff=25,
                               semialigned_clip=True)
    tcfg = tpipe.AlignConfig(**dataclasses.asdict(jcfg))
    j = _paired_jit(env["jarr"], b1, q1, b2, q2, jcfg,
                    jpairs.TlsStatic(**TLS), tm1, tm2)
    t = pairs.align_paired_batch(
        env["tarr"], *(torch.from_numpy(x) for x in (b1, q1, b2, q2)),
        tcfg, pairs.TlsStatic(**TLS), torch.from_numpy(tm1),
        torch.from_numpy(tm2))
    floats = ("pair_total_prob", "pair_best_lp", "pair_log_scale",
              "others_sum_1", "others_sum_2", "log_scale_1", "log_scale_2",
              "log_prob_1", "log_prob_2")
    scores = ("frag_score_1", "frag_score_2", "template_score")
    _assert_dicts_equal(t, j, floats=floats, skip=scores)
    for k in scores:
        d = np.abs(_np(t[k]).astype(np.int64) - _np(j[k]))
        assert d.max() <= 1 and (d > 0).sum() <= 1, k
    assert _np(j["qtrim_1"]).any() and _np(j["sa_do_1"]).any()
    assert _np(j["proper_pair"]).mean() > 0.7


def test_tls_learner_equals_jax():
    """Batches of 12,000 pairs (so UPDATE_FREQUENCY re-estimates run) with
    FRp, RFm and stray models; every statistic equal."""
    rng = np.random.default_rng(5)
    learners = (tls.TemplateLengthLearner(), jtls.TemplateLengthLearner())
    for _ in range(2):
        n = 12_000
        p = rng.integers(0, 5_000_000, n)
        ins = rng.normal(350, 40, n).astype(np.int64).clip(150, 900)
        strand = rng.random(n) < 0.5
        f1 = np.where(strand, p, p + ins - 100)
        f2 = np.where(strand, p + ins - 100, p)
        r1, r2 = ~strand, strand.copy()
        stray = rng.random(n) < 0.05
        r2[stray] = r1[stray]
        use = rng.random(n) < 0.9
        for lr in learners:
            lr.add_batch(f1, r1, 100, f2, r2, 100, use)
    got, want = (lr.finalize() for lr in learners)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tls.TEMPLATE_LENGTH_THRESHOLD == jtls.TEMPLATE_LENGTH_THRESHOLD
    assert got.best_models in ((1, 6), (6, 1))
    s = tls.TemplateLengthStatistics(min=200, max=500, median=350)
    js = jtls.TemplateLengthStatistics(min=200, max=500, median=350)
    m = rng.integers(0, 8, 100)
    ln = rng.integers(100, 60_000, 100)
    np.testing.assert_array_equal(s.nominal(m, ln), js.nominal(m, ln))
    np.testing.assert_array_equal(s.match_model(m, ln), js.match_model(m, ln))
    np.testing.assert_array_equal(
        tls.alignment_model(f1[:99], r1[:99], f2[:99], r2[:99]),
        jtls.alignment_model(f1[:99], r1[:99], f2[:99], r2[:99]))


def _host_res(env):
    """A paired result dict of the fixture (the JAX aligner's device
    result, fetched) for the host passes."""
    b1, q1, b2, q2 = _ends(env)
    res = _paired_jit(env["jarr"], b1, q1, b2, q2, env["jcfg"],
                      jpairs.TlsStatic(**TLS))
    return {k: np.array(v) for k, v in jax.device_get(res).items()}


def test_clip_semialigned_and_overlapping_equal_jax(env):
    res0 = _host_res(env)
    b1, q1, b2, q2 = _ends(env)
    g = env["genome"].codes
    n = len(b1)
    mask = np.zeros(n, bool)
    mask[::2] = True
    outs = []
    for mod in (clippers, jclippers):
        res = copy.deepcopy(res0)
        res["cigar_1"] = [None] * n
        res["cigar_1"][4] = "50M5D50M"
        res["cigar_2"] = [None] * n
        mod.clip_semialigned(res, "_1", g, b1, row_mask=mask)
        mod.clip_semialigned(res, "_2", g, b2)
        jb1 = jfastq.ReadBatch(list(range(n)), b1, q1, np.full(n, L, np.int32))
        jb2 = jfastq.ReadBatch(list(range(n)), b2, q2, np.full(n, L, np.int32))
        mod.clip_overlapping(res, jb1, jb2, g)
        outs.append(res)
    t, j = outs
    assert t.keys() == j.keys()
    for k in j:
        if isinstance(j[k], list):
            assert t[k] == j[k], k
        else:
            np.testing.assert_array_equal(t[k], j[k], k)
    clipped = [c for c in j["cigar_1"] + j["cigar_2"] if c and "S" in c]
    assert len(clipped) >= 4
    np.testing.assert_array_equal(
        clippers._first_run_start(np.asarray(b1[:, :30] == b2[:, :30]), 3),
        jclippers._first_run_start(np.asarray(b1[:, :30] == b2[:, :30]), 3))


@pytest.mark.parametrize("kw", [{}, {"pessimistic": True},
                                {"mapq_threshold": 30}],
                         ids=["defaults", "pessimistic", "mapq_threshold"])
def test_from_paired_result_equals_jax(env, kw):
    res = _host_res(env)
    b1, q1, b2, q2 = _ends(env)
    n = len(b1)
    names = [f"t{i}" for i in range(n)]
    res["cigar_1"] = [None] * n
    res["cigar_1"][2] = "3S97M"
    res["cigar_2"] = [None] * n
    res["cigar_2"][5] = "40M4D60M"
    fbs = []
    for mod, fq in ((storage, fastq), (jstorage, jfastq)):
        mk = lambda b, q: fq.pad_batch(fq.ReadBatch(
            names, b, q, np.full(n, L, np.int32)), 160)
        pad = {k: (np.concatenate([v, np.zeros((160 - n,) + v.shape[1:],
                                               v.dtype)])
                   if isinstance(v, np.ndarray) and v.ndim and v.shape[0] == n
                   else (v + [None] * (160 - n) if isinstance(v, list)
                         else v))
               for k, v in res.items()}
        fbs.append(mod.from_paired_result(env["genome"], mk(b1, q1),
                                          mk(b2, q2), pad, **kw))
    t, j = fbs
    assert len(t) == len(j) == 2 * n
    for f in dataclasses.fields(j):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, f.name)
        else:
            assert a == b, f.name
