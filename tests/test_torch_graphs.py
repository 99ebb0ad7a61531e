"""The batch's device program as a CUDA graph (`graphs.ProgramGraphs`), on
the CPU: the program a driver would capture makes no host copy and no host
sync between its inputs' upload and its output dict, and the helper's
policy (eager on the CPU; eager on a key's first sight, capture on its
second, replay after; keys by shape and TLS; LRU eviction; graphs dropped
with the planes; the counters), with a stub in place of the CUDA capture.
The capture and replay themselves run on the card
(`tests/test_torch_cuda.py`, `-k graph`)."""

import types

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from isaac_aligner_tpu_torch import graphs, synthetic
from isaac_aligner_tpu_torch.align.pairs import TlsStatic
from isaac_aligner_tpu_torch.align.pipeline import (AlignConfig,
                                                    default_seed_offsets)
from isaac_aligner_tpu_torch.aligner import Aligner, PairedAligner
from isaac_aligner_tpu_torch.graphs import upload
from isaac_aligner_tpu_torch.index.build import build_index
from isaac_aligner_tpu_torch.io.fasta import genome_from_sequences
from isaac_aligner_tpu_torch.io.fastq import ReadBatch
from isaac_aligner_tpu_torch.parallel.multi_index import (
    MultiIndexAligner, MultiIndexPairedAligner)

L = 100
N = 64
TLS = TlsStatic(min=200, max=400, mate_min=200, mate_max=400, best0=1,
                best1=6, median=300)

#: ops that copy a host value onto the device (`torch.tensor`) or make the
#: host wait for one (a scalar read, a data-dependent size)
FORBIDDEN = {"aten.lift_fresh.default", "aten.lift_fresh_copy.default",
             "aten._local_scalar_dense.default", "aten.nonzero.default",
             "aten.masked_select.default", "aten.item.default"}

#: the driver options of the cells and of the seed stage's other modes:
#: (aligner options, AlignConfig fields)
OPTIONS = {
    "defaults": ({}, {}),
    "noclip": ({"base_quality_cutoff": 0, "clip_semialigned": False,
                "semialigned_gap_limit": 0}, {}),
    "seed64": ({}, {"seed_len": 64}),
    "neighbors": ({}, {"neighborhood_size_threshold": 100}),
    "scatter": ({}, {"scatter_repeats": True}),
}


def _seq(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


@pytest.fixture(scope="module")
def world():
    """A 30 kbp genome with an N run (its 32-mer index), N pairs of
    L-base reads from it, their qualities, and a second 10 kbp genome's
    index (a second contig group)."""
    rng = np.random.default_rng(29)
    genome = genome_from_sequences([
        ("c1", _seq(rng, 15_000) + "N" * 300 + _seq(rng, 15_000))])
    index = build_index(genome, seed_len=32, device="cpu")
    other = build_index(genome_from_sequences([("c2", _seq(rng, 10_000))]),
                        seed_len=32, device="cpu")
    sp = synthetic.make_pairs(rng, genome.codes, N, read_len=L,
                              indel_frac=0.2, damaged_frac=0.1, far_frac=0.0)
    quals = rng.integers(2, 41, (2, N, L)).astype(np.uint8)
    return index, sp.bases1, sp.bases2, quals, other


def _batch(bases, quals, tag=""):
    n = bases.shape[0]
    return ReadBatch(names=[f"t{tag}{i}" for i in range(n)],
                     bases=bases.copy(), quals=quals.copy(),
                     lengths=np.full(n, bases.shape[1], np.int32))


def _create(cls, index, option):
    opts, fields = OPTIONS[option]
    cfg = None
    if fields:
        seed_len = fields.get("seed_len", 32)
        cfg = AlignConfig(seed_len=seed_len,
                          seed_offsets=default_seed_offsets(L, seed_len),
                          **{k: v for k, v in fields.items()
                             if k != "seed_len"})
    return cls.create(index, read_len=L, cfg=cfg, device="cpu", **opts)


class _Guard(TorchDispatchMode):
    """Records every aten op; a boolean index (a data-dependent size) is
    recorded as a nonzero."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        name = str(func)
        if name.startswith(("aten.index.", "aten.index_put")):
            idx = args[1] if len(args) > 1 else ()
            if any(isinstance(t, torch.Tensor) and t.dtype == torch.bool
                   for t in (idx or ())):
                name = "aten.nonzero.default"
        self.ops.append(name)
        return func(*args, **(kwargs or {}))


def _guarded(program, inputs, monkeypatch) -> tuple[list, dict]:
    """Run `program` on `inputs` (already on the device) with every host
    read of a tensor and every numpy upload made to fail, under the op
    recorder; returns (ops, output dict)."""
    def refuse(what):
        def fail(*_a, **_k):
            raise AssertionError(f"{what} inside the device program")
        return fail
    with monkeypatch.context() as m:
        m.setattr(torch, "from_numpy", refuse("torch.from_numpy"))
        m.setattr(torch, "as_tensor", refuse("torch.as_tensor"))
        for attr in ("cpu", "numpy", "tolist", "item"):
            m.setattr(torch.Tensor, attr, refuse(f"Tensor.{attr}"))
        with _Guard() as guard:
            out = program(*inputs)
    return guard.ops, out


@pytest.mark.parametrize("paired", [True, False], ids=["paired", "single"])
@pytest.mark.parametrize("option", list(OPTIONS))
def test_device_program_is_capture_safe(world, option, paired, monkeypatch):
    """The program `_dispatch` hands the graph helper issues no host copy
    and no host sync from its inputs' upload to its output dict, and its
    answers are the eager dispatch's.  It runs once before the guard, as
    the capture's warm-up does: constants made once per device
    (`pipeline.device_ints`) are in place by then."""
    index, b1, b2, quals, other = world
    if paired:
        al = _create(PairedAligner, index, option)
        al.tls = TLS
        batches = (_batch(b1, quals[0]), _batch(b2, quals[1]))
        program = al._program(TLS)
        inputs = []
        for b in batches:
            inputs += [b.bases, b.quals, np.zeros(N, np.int32)]
    else:
        al = _create(Aligner, index, option)
        batches = (_batch(b1, quals[0]),)
        program = al._program()
        inputs = [b1, quals[0], np.zeros(N, np.int32)]
    dev_inputs = [upload(x, al.device) for x in inputs]
    program(*dev_inputs)
    ops, out = _guarded(program, dev_inputs, monkeypatch)
    assert len(ops) > 500
    assert not FORBIDDEN & set(ops), sorted(FORBIDDEN & set(ops))
    eager = al._dispatch(*batches)[0]
    assert eager.keys() == out.keys()
    for k, v in out.items():
        assert torch.equal(v, eager[k]), k


# -- the helper's policy, with a stub capture --------------------------------

class _Planes:
    """Stands for the IndexArrays a program reads (weak-referenceable)."""


class _StubCaptured:
    """`graphs._Captured` without CUDA: `load` keeps the inputs, `capture`
    runs the program once eagerly (as the warm-up), and the graph's replay
    runs it on the loaded inputs into the same output tensors."""

    made = 0

    def __init__(self, inputs, device):
        type(self).made += 1
        self.inputs = None
        self.graph = None
        self.outputs = None

    def load(self, inputs):
        self.inputs = [torch.from_numpy(np.array(x)) for x in inputs]

    def capture(self, program, pool):
        self.outputs = program(*self.inputs)

        def replay():
            for k, v in program(*self.inputs).items():
                self.outputs[k].copy_(v)
        self.graph = types.SimpleNamespace(replay=replay)


def _tally():
    return types.SimpleNamespace(graph_replays=0, graph_captures=0,
                                 eager_dispatches=0)


@pytest.fixture
def stubbed(monkeypatch):
    monkeypatch.setattr(graphs, "_Captured", _StubCaptured)
    monkeypatch.setattr(graphs, "upload",
                        lambda x, device: torch.from_numpy(np.array(x)))
    _StubCaptured.made = 0
    return torch.device("cuda")


def _program(x):
    return {"twice": x * 2, "sum": x.sum()}


def test_graph_policy_eager_on_cpu():
    g, tally = graphs.ProgramGraphs(), _tally()
    x = np.arange(6, dtype=np.int32)
    for _ in range(4):
        out = g.run("k", _program, (x,), torch.device("cpu"), _Planes(),
                    tally)
        assert torch.equal(out["twice"], torch.from_numpy(x * 2))
    assert (tally.eager_dispatches, tally.graph_captures,
            tally.graph_replays) == (4, 0, 0)
    assert len(g) == 0


@pytest.mark.parametrize("change", ["shape", "dtype", "key"])
def test_graph_policy_first_eager_second_capture_then_replay(stubbed,
                                                             change):
    """Each key: its first sight eager, its second a capture, replays
    after; a new shape, dtype or caller's key (a TLS model) is a new key.
    Every sight's answer is the program's on its own inputs."""
    g, tally, planes = graphs.ProgramGraphs(), _tally(), _Planes()
    rng = np.random.default_rng(1)
    a = [rng.integers(0, 9, 8).astype(np.int32) for _ in range(4)]
    other = {"shape": ("k", [rng.integers(0, 9, 5).astype(np.int32)
                             for _ in range(4)]),
             "dtype": ("k", [x.astype(np.int64) for x in a]),
             "key": ("k2", a)}[change]
    seen = []
    for key, xs in (("k", a), other):
        for x in xs:
            out = g.run(key, _program, (x,), stubbed, planes, tally)
            assert torch.equal(out["twice"], torch.from_numpy(x * 2))
            assert int(out["sum"]) == int(x.sum())
            seen.append((tally.eager_dispatches, tally.graph_captures,
                         tally.graph_replays))
    assert seen == [(1, 0, 0), (1, 1, 0), (1, 1, 1), (1, 1, 2),
                    (2, 1, 2), (2, 2, 2), (2, 2, 3), (2, 2, 4)]
    assert len(g) == 2 and _StubCaptured.made == 2


def test_graph_policy_lru_eviction_and_planes(stubbed, monkeypatch):
    """At most `KEEP` keys: the least recently used goes with its graph
    and starts over; other planes, or `clear`, drop every graph."""
    monkeypatch.setattr(graphs, "KEEP", 2)
    g, tally, planes = graphs.ProgramGraphs(), _tally(), _Planes()
    x = np.arange(4, dtype=np.int32)

    def run(key, p=planes):
        g.run(key, _program, (x,), stubbed, p, tally)
        return (tally.eager_dispatches, tally.graph_captures,
                tally.graph_replays)

    assert [run("a"), run("a"), run("b"), run("b")] == \
        [(1, 0, 0), (1, 1, 0), (2, 1, 0), (2, 2, 0)]
    assert run("a") == (2, 2, 1)           # "a" the most recent now
    assert run("c") == (3, 2, 1)           # "b" evicted
    assert len(g) == 1
    assert run("a") == (3, 2, 2)
    assert run("b") == (4, 2, 2)           # seen afresh: eager
    assert run("b") == (4, 3, 2)
    other = _Planes()
    assert run("a", other) == (5, 3, 2)    # other planes: all dropped
    assert len(g) == 0
    assert run("a", other) == (5, 4, 2)
    g.clear()
    assert len(g) == 0 and run("a", other) == (6, 4, 2)


def test_graph_policy_release_device_and_counters(world, stubbed,
                                                  monkeypatch):
    """The drivers count every dispatch once: the graph helper's path
    into `graph_replays`, `graph_captures` or `eager_dispatches` (summed
    over groups by the multi-index drivers, which give their groups one
    pool); `release_device` drops the aligner's graphs."""
    index, b1, b2, quals, other = world
    al = PairedAligner.create(index, read_len=L, device="cpu")
    al.tls = TLS
    monkeypatch.setattr(al, "device", stubbed)
    batches = (_batch(b1, quals[0]), _batch(b2, quals[1]))
    eager = PairedAligner.create(index, read_len=L, device="cpu")
    eager.tls = TLS
    want = eager._dispatch(*batches)[0]
    for _ in range(4):
        out = al._dispatch(*batches)[0]
        for k, v in want.items():
            assert torch.equal(out[k], v), k
    assert (al.eager_dispatches, al.graph_captures, al.graph_replays) == \
        (1, 1, 2)
    assert len(al.graphs) == 1
    al.release_device()
    assert len(al.graphs) == 0 and al.arrays is None
    assert eager.eager_dispatches == 1 and eager.graph_replays == 0

    multi = MultiIndexPairedAligner.create([index, other], read_len=L,
                                           device="cpu")
    assert multi.aligners[0].graphs.pool is multi.aligners[1].graphs.pool
    single = MultiIndexAligner.create([index, other], read_len=L,
                                      device="cpu")
    assert single.aligners[0].graphs.pool is single.aligners[1].graphs.pool
    assert al.graphs.pool is not eager.graphs.pool
    multi.tls = TLS
    for a in multi.aligners:
        monkeypatch.setattr(a, "device", stubbed)
    for _ in range(3):
        multi._dispatch_all(*batches)
    assert (multi.eager_dispatches, multi.graph_captures,
            multi.graph_replays) == (2, 2, 2)


def test_graph_policy_groups_replay_in_capture_order(world, stubbed,
                                                    monkeypatch):
    """The groups of a multi-index driver share one pool, so a round must
    replay their graphs in the order they were captured: in step they do,
    and where group 1's key history runs ahead of group 0's (its graph
    captured first, group 0's later, then both replayed in group order)
    the round raises before any fetch."""
    index, b1, b2, quals, other = world
    batches = (_batch(b1, quals[0]), _batch(b2, quals[1]))
    multi = MultiIndexPairedAligner.create([index, other], read_len=L,
                                           device="cpu")
    multi.tls = TLS
    for a in multi.aligners:
        monkeypatch.setattr(a, "device", stubbed)
    lasts = []
    for _ in range(4):
        multi._dispatch_all(*batches)
        lasts.append([a.graphs.last for a in multi.aligners])
    assert lasts[0] == [None, None]
    assert lasts[1][0] < lasts[1][1] and lasts[2:] == [lasts[1]] * 2

    ahead = MultiIndexPairedAligner.create([index, other], read_len=L,
                                           device="cpu")
    ahead.tls = TLS
    for a in ahead.aligners:
        monkeypatch.setattr(a, "device", stubbed)
    g0, g1 = ahead.aligners
    g1._dispatch(*batches)
    g1._dispatch(*batches)                 # group 1 captures first
    ahead._dispatch_all(*batches)          # group 0 eager, group 1 replays
    with pytest.raises(RuntimeError, match="capture order"):
        ahead._dispatch_all(*batches)      # group 0 captures, 1 replays
    assert g0.graphs.last > g1.graphs.last
