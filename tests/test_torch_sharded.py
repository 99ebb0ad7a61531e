"""Port's SPMD path (`parallel/sharded.py`, `parallel/sharded_aligner.py`,
`build.dedup.mark_duplicates_collective`, the `--devices` workflow) vs the
JAX package's on its 8 CPU devices, at tests/test_sharded.py's fixtures.

Port meshes are [data, shard] arrays of `cpu` entries.  Against the
port's single-device program every field is equal (floats bit-equal);
against the JAX package integer fields are equal, floats agree to f32
rounding and scores to floor flips, as in the other port tests."""

import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from isaac_aligner_tpu import dna as jdna
from isaac_aligner_tpu.align.pairs import TlsStatic as JTls
from isaac_aligner_tpu.align.pipeline import AlignConfig as JConfig
from isaac_aligner_tpu.index.build import build_index
from isaac_aligner_tpu.io.fasta import genome_from_sequences
from isaac_aligner_tpu.io.fastq import ReadBatch as JBatch
from isaac_aligner_tpu.parallel import sharded as jsh
from isaac_aligner_tpu.parallel import sharded_aligner as jsa
from isaac_aligner_tpu.workflow import align as jwf
from isaac_aligner_tpu_torch.align import pipeline
from isaac_aligner_tpu_torch.align.pairs import TlsStatic, align_paired_batch
from isaac_aligner_tpu_torch.build import dedup
from isaac_aligner_tpu_torch.io.fastq import ReadBatch
from isaac_aligner_tpu_torch.parallel import sharded as sh
from isaac_aligner_tpu_torch.parallel import sharded_aligner as sa
from isaac_aligner_tpu_torch.aligner import Aligner, PairedAligner
from isaac_aligner_tpu_torch.workflow import align as wf

from test_torch_host import to_port_index

READ_LEN = 48
MESHES = [(1, 1), (2, 2), (1, 4)]
OUTPUTS = ("sorted.bam", "sorted.bam.bai", "sorted.bam.md5")
TLS = dict(min=250, max=550, mate_min=250, mate_max=550, best0=1, best1=6)


@pytest.fixture(scope="module")
def ref():
    rng = np.random.default_rng(3)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 3000))
    genome = genome_from_sequences([("chrS", seq)])
    jidx = build_index(genome, seed_len=16)
    return seq, jidx, to_port_index(jidx)


def _rc(s: str) -> str:
    return jdna.decode(jdna.revcomp(jdna.encode(s)))


def _single_reads(seq, n=32, seed=31):
    """n reads: both strands, a substitution on every fifth, two random
    reads (unaligned), and a low-quality tail on every third (the device
    quality trim)."""
    rng = np.random.default_rng(seed)
    reads = []
    for i in range(n):
        p = int(rng.integers(0, len(seq) - READ_LEN))
        r = seq[p:p + READ_LEN]
        if i % 2:
            r = _rc(r)
        if i % 5 == 1:
            r = r[:20] + ("T" if r[20] != "T" else "G") + r[21:]
        if i in (7, 22):
            r = "".join("ACGT"[x] for x in rng.integers(0, 4, READ_LEN))
        reads.append(r)
    bases = np.stack([jdna.encode(r) for r in reads]).astype(np.uint8)
    quals = np.full(bases.shape, 30, np.uint8)
    quals[::3, -6:] = 5
    return [f"r{i}" for i in range(n)], bases, quals


def _pair_reads(seq, n=16, seed=23):
    """n pairs of FR templates 300-500 bp; every fourth read 1 scrambled
    so that only the rescue places it."""
    rng = np.random.default_rng(seed)
    r1s, r2s = [], []
    for i in range(n):
        p = int(rng.integers(0, len(seq) - 600))
        t = int(rng.integers(300, 500))
        r1 = seq[p:p + READ_LEN]
        if i % 4 == 1:
            r1 = "".join("A" if j % 7 == 3 and c != "A" else c
                         for j, c in enumerate(r1))
        r1s.append(r1)
        r2s.append(_rc(seq[p + t - READ_LEN:p + t]))
    enc = [np.stack([jdna.encode(r) for r in rs]).astype(np.uint8)
           for rs in (r1s, r2s)]
    q = np.full(enc[0].shape, 30, np.uint8)
    return [f"p{i}" for i in range(n)], enc[0], q, enc[1], q.copy()


def _np(res: dict) -> dict:
    return {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in res.items()}


def _masked(res: dict, k: str) -> np.ndarray:
    """A result field; candidate grids only in their valid slots (the
    padding's content follows the concatenated hit-list layout)."""
    v = res[k]
    if k.startswith("cand_") and not k.startswith("cand_valid"):
        return np.where(res["cand_valid" + k[len(k.rstrip("_12")):]], v, 0)
    return v


def assert_equal(a: dict, b: dict, keys=None) -> None:
    """Every field equal, floats bit for bit."""
    keys = keys or sorted(set(a) & set(b))
    for k in keys:
        np.testing.assert_array_equal(_masked(a, k), _masked(b, k),
                                      err_msg=k)


def assert_like_jax(port: dict, jax: dict) -> None:
    """Integer fields equal, floats to f32 rounding, scores to floor flips
    (the port sums per-base terms in float64, pipeline.sum_f32)."""
    for k in sorted(set(port) & set(jax)):
        a, b = _masked(port, k), _masked(jax, k)
        if a.dtype.kind == "f":
            fin = np.isfinite(b)
            np.testing.assert_array_equal(np.isfinite(a), fin, err_msg=k)
            np.testing.assert_allclose(a[fin], b[fin], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        elif k.startswith(("mapq", "frag_score", "template_score")):
            d = np.abs(a.astype(np.int64) - b.astype(np.int64))
            assert d.max(initial=0) <= 1 and (d > 0).sum() <= 1, k
        else:
            np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=k)


def _cfgs(jidx, **kw):
    base = dict(seed_len=16, seed_offsets=(0, 16, 32),
                genome_len=jidx.genome.total_length, **kw)
    return JConfig(**base), pipeline.AlignConfig(**base)


def _meshes(data, shard):
    return (jsh.make_mesh(data * shard, data=data, shard=shard),
            sh.make_mesh(data * shard, data=data, shard=shard, device="cpu"))


@pytest.mark.parametrize("k", [16, 32, 64])
def test_shard_index_equals_jax(k):
    rng = np.random.default_rng(k)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 4000))
    # a repeated segment: long k-mer runs sit next to the cuts
    seq = seq[:1000] + seq[500:1300] + seq[1000:]
    jidx = build_index(genome_from_sequences([("c", seq)]), seed_len=k)
    j = jsh.shard_index(jidx, 4)
    t = sh.shard_index(to_port_index(jidx), 4)
    for f in ("key_hi", "key_lo", "pos", "n_real", "has_neighbors",
              "bucket_starts", "genome_packed", "genome_nbits",
              "contig_starts", "contig_ends"):
        np.testing.assert_array_equal(getattr(t, f), np.asarray(getattr(j, f)),
                                      err_msg=f)
    assert len(t.key_mids) == len(j.key_mids) == (2 if k == 64 else 0)
    for a, b in zip(t.key_mids, j.key_mids):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert int(t.n_real.sum()) == jidx.num_records


@pytest.mark.parametrize("data,shard", MESHES)
def test_sharded_align_equals_jax_and_single(ref, data, shard):
    seq, jidx, pidx = ref
    _names, bases, quals = _single_reads(seq)
    trims = np.zeros(len(bases), np.int32)
    trims[4::7] = 3
    lengths = np.full(len(bases), READ_LEN, np.int32)
    jmesh, tmesh = _meshes(data, shard)
    jsharded = jsh.place_sharded(jmesh, jsh.shard_index(jidx, shard))
    placed = sh.place_sharded(tmesh, sh.shard_index(pidx, shard))
    arrays = pipeline.prepare_index(pidx, "cpu")

    jcfg, tcfg = _cfgs(jidx)
    plain = _np(sh.sharded_align(tmesh, placed, bases, quals, tcfg))
    assert_like_jax(plain, _np(jax.jit(
        lambda s, b, q: jsh.sharded_align(jmesh, s, b, q, jcfg))(
            jsharded, bases, quals)))
    if data == 1:
        assert_equal(plain, _np(pipeline.align_batch(
            arrays, torch.from_numpy(bases), torch.from_numpy(quals), tcfg)))

    jcfg, tcfg = _cfgs(jidx, quality_trim_cutoff=20, semialigned_clip=True)
    full = _np(sh.sharded_align_full(tmesh, placed, bases, quals, tcfg,
                                     trims, lengths))
    assert_like_jax(full, _np(jax.jit(
        lambda s, b, q, t, n: jsh.sharded_align_full(jmesh, s, b, q, jcfg,
                                                     t, n))(
            jsharded, bases, quals, trims, lengths)))
    tm = torch.from_numpy(trims)
    mb, mq = pipeline.mask_tail_device(torch.from_numpy(bases),
                                       torch.from_numpy(quals), tm)
    if data == 1:
        assert_equal(full, _np(pipeline.align_batch(arrays, mb, mq, tcfg, tm)))
    assert full["aligned"].sum() >= 28 and full["qtrim"].sum() > 0


def test_sharded_paired_exact_across_mesh_sizes(ref):
    """The paired program with in-program rescue: the port equal on every
    mesh, and like the JAX program on its (1, 1) and (2, 4) meshes."""
    seq, jidx, pidx = ref
    _n, b1, q1, b2, q2 = _pair_reads(seq)
    jcfg, tcfg = _cfgs(jidx)
    outs = {}
    for data, shard in ((1, 1), (2, 4), (2, 2), (1, 4)):
        jmesh, tmesh = _meshes(data, shard)
        placed = sh.place_sharded(tmesh, sh.shard_index(pidx, shard))
        outs[data, shard] = _np(sh.sharded_align_paired(
            tmesh, placed, b1, q1, b2, q2, tcfg, TlsStatic(**TLS)))
        if (data, shard) in ((1, 1), (2, 4)):
            jres = jax.jit(lambda s, a1, c1, a2, c2, m=jmesh:
                           jsh.sharded_align_paired(m, s, a1, c1, a2, c2,
                                                    jcfg, JTls(**TLS)))(
                jsh.place_sharded(jmesh, jsh.shard_index(jidx, shard)),
                b1, q1, b2, q2)
            assert_like_jax(outs[data, shard], _np(jres))
    one = outs[1, 1]
    assert one["aligned_1"].all(), "rescue must recover read 1"
    assert one["rescued_1"].sum() >= 3 and one["proper_pair"].sum() >= 14
    assert int(one["rescue_dropped"]) == 0
    for key in outs:
        assert_equal(one, outs[key])


def _driver_inputs(seq, paired: bool, jax: bool):
    cls = JBatch if jax else ReadBatch
    if paired:
        names, b1, q1, b2, q2 = _pair_reads(seq, seed=37)
        return tuple(cls(list(names), b.copy(), q.copy(),
                         np.full(len(b), READ_LEN, np.int32))
                     for b, q in ((b1, q1), (b2, q2)))
    names, bases, quals = _single_reads(seq, seed=41)
    return (cls(list(names), bases, quals,
                np.full(len(bases), READ_LEN, np.int32)),)


DRIVER_KEYS = {
    False: ("aligned", "start", "reverse", "mapq", "edit_distance",
            "mismatches"),
    True: ("aligned_1", "aligned_2", "start_1", "start_2", "reverse_1",
           "reverse_2", "proper_pair", "template_length", "template_score",
           "frag_score_1", "frag_score_2", "edit_distance_1",
           "edit_distance_2")}


@pytest.mark.parametrize("genome_sharded", [False, True],
                         ids=["index_sharded", "genome_sharded"])
@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
def test_drivers_equal_single_device_and_jax(ref, paired, genome_sharded):
    """ShardedAligner / ShardedPairedAligner over (2, 4) meshes: the
    port's single-device driver's fields and CIGARs, and the JAX
    sharded driver's (scores to floor flips)."""
    seq, jidx, pidx = ref
    jcfg, tcfg = _cfgs(jidx)
    kw = dict(read_len=READ_LEN, base_quality_cutoff=20,
              genome_sharded=genome_sharded)
    jmesh, tmesh = _meshes(2, 4)
    if paired:
        one = PairedAligner.create(pidx, read_len=READ_LEN, cfg=tcfg,
                                   base_quality_cutoff=20, device="cpu")
        many = sa.ShardedPairedAligner.create_sharded(pidx, mesh=tmesh,
                                                      cfg=tcfg, **kw)
        jal = jsa.ShardedPairedAligner.create_sharded(jidx, mesh=jmesh,
                                                      cfg=jcfg, **kw)
        for al, tls in ((one, TlsStatic), (many, TlsStatic), (jal, JTls)):
            al.tls = tls(**TLS)
    else:
        one = Aligner.create(pidx, read_len=READ_LEN, cfg=tcfg,
                             base_quality_cutoff=20, device="cpu")
        many = sa.ShardedAligner.create_sharded(pidx, mesh=tmesh, cfg=tcfg,
                                                **kw)
        jal = jsa.ShardedAligner.create_sharded(jidx, mesh=jmesh, cfg=jcfg,
                                                **kw)
    assert many.arrays is None and many.device == torch.device("cpu")
    r1 = one.align_batch_arrays(*_driver_inputs(seq, paired, False))
    r8 = many.align_batch_arrays(*_driver_inputs(seq, paired, False))
    rj = jal.align_batch_arrays(*_driver_inputs(seq, paired, True))
    keys = DRIVER_KEYS[paired]
    assert_equal(_np({k: r1[k] for k in keys}), _np({k: r8[k] for k in keys}))
    assert_like_jax(_np({k: r8[k] for k in keys}),
                    _np({k: rj[k] for k in keys}))
    for sfx in ("_1", "_2") if paired else ("",):
        assert r1.get("cigar" + sfx) == r8.get("cigar" + sfx) \
            == rj.get("cigar" + sfx)
    if paired:
        assert r8["aligned_1"].all(), "rescue must recover read 1"
    if genome_sharded:
        # a shard holds its G/S + halo slice, never the whole plane
        gp = many.genome_shards.planes[0][0][0]
        whole = pipeline.pack_genome(pidx.genome.codes)[0]
        assert gp.shape[0] == np.asarray(jal.genome_shards.gp).shape[1]
        assert all(loc.genome_packed.numel() == 0
                   for row in many.placed for loc in row)
        assert gp.shape[0] < whole.shape[0] or \
            pidx.genome.total_length < 4 * sh.GS_HALO


def test_genome_sharded_learn_tls_equals_single(ref):
    seq, _jidx, pidx = ref
    b1, b2 = _driver_inputs(seq, True, False)
    one = PairedAligner.create(pidx, read_len=READ_LEN, device="cpu")
    many = sa.ShardedPairedAligner.create_sharded(
        pidx, mesh=sh.make_mesh(4, device="cpu"), read_len=READ_LEN,
        genome_sharded=True)
    assert dataclasses.asdict(one.learn_tls([(b1, b2)])) == \
        dataclasses.asdict(many.learn_tls([(b1, b2)]))


def _np_dedup_oracle(a_self, a_mate, rank, tie, cls, lib):
    """Group by (cls, lib, a_self, a_mate), keep the best (rank, tie)."""
    dup = np.zeros(len(a_self), bool)
    groups: dict = {}
    for i in range(len(a_self)):
        if cls[i] >= 0:
            groups.setdefault((cls[i], lib[i], a_self[i], a_mate[i]),
                              []).append(i)
    for rows in groups.values():
        rows.sort(key=lambda i: (-rank[i], -tie[i]))
        dup[rows[1:]] = True
    return dup


@pytest.mark.parametrize("capacity_factor", [4.0, 0.25],
                         ids=["oracle", "overflow"])
def test_collective_dedup_equals_jax(capacity_factor):
    from jax.sharding import Mesh as JMesh

    rng = np.random.default_rng(5)
    # past 64 rows a device, the capacity floor min(n_loc, 64) stops
    # covering the hot anchor's rows
    n = 2048
    # clustered anchors (real groups), one hot anchor (the overflow)
    a_self = rng.integers(0, 40, n).astype(np.int64) * 2 + rng.integers(0, 2, n)
    a_self[::3] = 1 << 33
    a_mate = rng.integers(0, 40, n).astype(np.int64) * 2
    rank = rng.integers(0, 1 << 40, n).astype(np.int64)
    tie = rng.integers(0, 1 << 40, n).astype(np.int64)
    cls = rng.integers(-1, 4, n).astype(np.int64)
    lib = rng.integers(0, 2, n).astype(np.int64)
    args = (a_self, a_mate, rank, tie, cls, lib)
    jmesh = JMesh(np.array(jax.devices()[:8]), ("dev",))
    jflags, jover = jax.jit(lambda: jsh.collective_dedup(
        jmesh, "dev", *args, capacity_factor=capacity_factor))()
    flags, over = sh.collective_dedup(["cpu"] * 8, *args,
                                      capacity_factor=capacity_factor)
    np.testing.assert_array_equal(flags, np.asarray(jflags))
    np.testing.assert_array_equal(over, np.asarray(jover))
    if capacity_factor == 4.0:
        assert over.sum() == 0
        np.testing.assert_array_equal(flags, _np_dedup_oracle(*args))
    else:
        assert over.sum() > 0
        want = _np_dedup_oracle(*args)
        assert not (flags & ~want).any()     # overflow rows stay unmarked


def test_mark_duplicates_collective_equals_batch():
    from isaac_aligner_tpu_torch.build.records import FragmentBatch

    rng = np.random.default_rng(9)
    n = 301
    fb = FragmentBatch.empty(n, 1)
    fb.flag = rng.choice(np.array([0x1 | 0x2, 0x1 | 0x8, 0x1 | 0x4, 0, 0x4],
                                  np.uint16), n)
    fb.anchor_self = rng.integers(0, 30, n).astype(np.int64)
    fb.anchor_mate = rng.integers(0, 5, n).astype(np.int64)
    fb.dup_rank = rng.integers(0, 50, n).astype(np.int64)
    fb.dup_tie = rng.integers(0, 3, n).astype(np.int64)
    fb.rg = np.zeros(n, np.int32)
    want = dedup.mark_duplicates_batch(fb.take(np.arange(n)), None)
    got = dedup.mark_duplicates_collective(fb.take(np.arange(n)),
                                           sh.make_mesh(4, device="cpu"))
    assert ((want.flag & 0x400) != 0).sum() > 0
    np.testing.assert_array_equal(got.flag, want.flag)


#: case -> (port options, whether the JAX --devices 4 run is its twin)
WF_CASES = {"plain": ({}, True),
            "shard_genome": ({"shard_genome": True}, True),
            # three bins, each marked collectively
            "several_bins": ({"records_per_bin": 24}, False)}


@pytest.fixture(scope="module")
def wf_inputs(tmp_path_factory) -> Path:
    """test_sharded.py::test_workflow_devices_byte_identical's inputs: 32
    pairs on two contigs with mutated read 1s (rescue) and duplicates."""
    d = tmp_path_factory.mktemp("spmd_wf")
    rng = np.random.default_rng(11)
    g = "".join("ACGT"[i] for i in rng.integers(0, 4, 9000))
    (d / "ref.fa").write_text(">c1\n" + g[:5000] + "\n>c2\n" + g[5000:] + "\n")

    def rc(s):
        return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]

    with open(d / "r1.fq", "w") as f1, open(d / "r2.fq", "w") as f2:
        for i in range(32):
            p = int(rng.integers(0, 9000 - 500))
            t = int(rng.integers(300, 460))
            s1 = list(g[p:p + 80])
            if i % 5 == 1:
                for j in range(0, 80, 9):
                    s1[j] = "ACGT"[("ACGT".index(s1[j]) + 1) % 4]
            if i % 7 == 2:
                p, t = 800, 350
                s1 = list(g[p:p + 80])
            s2 = rc(g[p + t - 80:p + t])
            q = "".join(chr(33 + int(x)) for x in rng.integers(20, 40, 80))
            f1.write(f"@rd{i}\n{''.join(s1)}\n+\n{q}\n")
            f2.write(f"@rd{i}\n{s2}\n+\n{'I' * 80}\n")
    return d


def _wf_opts(mod, d: Path, out: Path, **kw):
    base = dict(reference=str(d / "ref.fa"), fastq1=str(d / "r1.fq"),
                fastq2=str(d / "r2.fq"), batch_size=16,
                records_per_bin=1000, tls_batches=2, output_dir=str(out))
    if mod is wf:
        base["device"] = "cpu"
    return mod.WorkflowOptions(**{**base, **kw})


@pytest.fixture(scope="module")
def wf_runs(wf_inputs, tmp_path_factory):
    """key -> output dir of each reference run, made once: the JAX
    package's --devices 4 run and the port's single-device runs."""
    done: dict = {}

    def get(key):
        if key not in done:
            mod, kw = {"jax4": (jwf, {"devices": 4}),
                       "port1": (wf, {}),
                       "port1_bins": (wf, {"records_per_bin": 24})}[key]
            out = tmp_path_factory.mktemp(key)
            mod.AlignWorkflow(_wf_opts(mod, wf_inputs, out, **kw)).run()
            done[key] = out
        return done[key]
    return get


@pytest.mark.parametrize("case", list(WF_CASES))
def test_workflow_devices_equal_jax_and_single(wf_inputs, wf_runs, tmp_path,
                                               case):
    """`--devices 4` (SPMD aligner + collective Build-phase dedup): the
    BAM, .bai and .md5 of the JAX --devices 4 run and of the port's
    single-device run."""
    kw, vs_jax = WF_CASES[case]
    run = wf.AlignWorkflow(_wf_opts(wf, wf_inputs, tmp_path / "port",
                                    devices=4, **kw))
    run.run()
    assert run._mesh().shape == {"data": 1, "shard": 4}
    refs = [wf_runs("port1_bins" if "records_per_bin" in kw else "port1")]
    if vs_jax:
        refs.append(wf_runs("jax4"))
    for name in OUTPUTS:
        got = (tmp_path / "port" / name).read_bytes()
        for ref in refs:
            assert got == (ref / name).read_bytes(), (name, ref)
    build = json.loads((tmp_path / "port" / "Stats" /
                        "BuildStats.json").read_text())
    assert build["duplicates"] > 0
    assert build["bins"] == (3 if case == "several_bins" else 1)


def test_devices_over_the_visible_cards_raise(wf_inputs, tmp_path):
    with pytest.raises(ValueError, match="visible"):
        sh.make_mesh(torch.cuda.device_count() + 1, device="cuda")
    run = wf.AlignWorkflow(wf.WorkflowOptions(
        reference=str(wf_inputs / "ref.fa"), output_dir=str(tmp_path / "o"),
        fastq1=str(wf_inputs / "r1.fq"),
        devices=torch.cuda.device_count() + 1))
    with pytest.raises((RuntimeError, ValueError)):
        run.run()
    assert not (tmp_path / "o" / "sorted.bam").exists()


def test_single_device_paired_keeps_stale_clip_of_moved_disjoined_row():
    """ROADMAP §C4: a disjoined pair whose read 1 first lands on a repeat
    copy (with a device semialigned clip) is moved by the rescue next to
    its mate.  The JAX single-device paired driver then applies the
    pre-rescue device clip, which puts the read back at the copy while the
    record keeps the rescued pair's flags: it keeps the stale clip.  The
    port's single-device driver clips the rescued end where it landed (the
    host pass), as the SPMD drivers, JAX's and the port's alike, re-clip
    rescued rows at their new placement: all three agree."""
    from isaac_aligner_tpu.aligner import PairedAligner as JPaired
    from isaac_aligner_tpu_torch import dna, synthetic

    rng = np.random.default_rng(0)
    genome = synthetic.make_genome(rng, 250_000,
                                   families=((600, 30, 0.02),),
                                   n_island=(150_000, 500))
    sp = synthetic.make_pairs(rng, genome.codes, 2048)
    jidx = build_index(genome_from_sequences(
        [(c.name, dna.decode(genome.codes[c.offset:c.end]))
         for c in genome.contigs]), seed_len=32)
    pidx = to_port_index(jidx)
    row = 518
    tls = dict(min=151, max=451, mate_min=151, mate_max=451, best0=6,
               best1=1, median=300)

    def batches(cls):
        return tuple(cls([f"t{row}"], b[row:row + 1].copy(),
                         np.full((1, 100), 30, np.uint8),
                         np.full(1, 100, np.int32))
                     for b in (sp.bases1, sp.bases2))
    one = PairedAligner.create(pidx, read_len=100, device="cpu")
    many = sa.ShardedPairedAligner.create_sharded(
        pidx, mesh=sh.make_mesh(1, device="cpu"), read_len=100)
    jal = JPaired.create(jidx, read_len=100)
    jmany = jsa.ShardedPairedAligner.create_sharded(
        jidx, mesh=jsh.make_mesh(8, data=1, shard=8), read_len=100)
    for al, cls in ((one, TlsStatic), (many, TlsStatic), (jal, JTls),
                    (jmany, JTls)):
        al.tls = cls(**tls)
    r1 = one.align_batch_arrays(*batches(ReadBatch))
    r8 = many.align_batch_arrays(*batches(ReadBatch))
    rj = jal.align_batch_arrays(*batches(JBatch))
    rj8 = jmany.align_batch_arrays(*batches(JBatch))
    truth = int(sp.start1[row])
    assert bool(r8["rescued_1"][0]) and abs(int(r8["start_1"][0]) - truth) <= 1
    # the JAX single-device driver keeps the stale clip of the copy
    assert abs(int(rj["start_1"][0]) - truth) > 10_000
    assert rj["proper_pair"][0]
    # the port's single-device driver re-clips as the SPMD drivers do
    assert one.reclipped == 1
    for k in ("start_1", "start_2", "reverse_1", "edit_distance_1",
              "proper_pair"):
        assert int(r1[k][0]) == int(r8[k][0]) == int(rj8[k][0]), k
    assert r1["cigar_1"][0] == r8["cigar_1"][0] == rj8["cigar_1"][0]
    assert int(r1["start_1"][0]) != int(rj["start_1"][0])
    assert r1["start_2"][0] == r8["start_2"][0] == rj["start_2"][0]
    # the reference's SPMD driver places the row as the port's does
    assert bool(rj8["rescued_1"][0])
    assert int(rj8["start_1"][0]) == int(r8["start_1"][0])
    assert rj8["cigar_1"][0] == r8["cigar_1"][0]
    assert rj8["start_2"][0] == r8["start_2"][0]
