"""The frozen generators give the same bytes for the same seed."""

import hashlib

import numpy as np

import generator
import harness

SMALL = {"contigs": [{"name": "a", "length": 200_000},
                     {"name": "b", "length": 150_000}],
         "n_block_fraction": 0.05,
         "families": [{"name": "f", "length": 300, "share": 0.05,
                       "divergence": [0.02, 0.1]},
                      {"name": "g", "length": [100, 400], "share": 0.05,
                       "divergence": [0.05, 0.2]}],
         "segdups": {"length": [1000, 3000], "share": 0.02,
                     "divergence": [0.01, 0.05]}}


def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _library(seed: int, pairs: int = 2000):
    g = generator.make_genome(dict(SMALL, seed=1))
    lib = harness.find_traffic("pe150_lib")["library"]
    return g, generator.make_library(g, dict(lib, far_min=50_000), pairs, seed)


def test_genome_same_bytes_for_same_seed():
    a = generator.make_genome(dict(SMALL, seed=7))
    b = generator.make_genome(dict(SMALL, seed=7))
    c = generator.make_genome(dict(SMALL, seed=8))
    assert _digest(a.codes) == _digest(b.codes)
    assert _digest(a.codes) != _digest(c.codes)
    assert a.names == ["a", "b"] and list(a.lengths) == [200_000, 150_000]
    # one central N block a contig
    for off, ln in zip(a.offsets, a.lengths):
        n = (a.codes[off:off + ln] == 4)
        assert n.sum() == int(ln * 0.05)
        assert n[:ln // 3].sum() == 0 and n[-ln // 3:].sum() == 0


def test_library_same_bytes_for_same_seed():
    _, a = _library(2**31 + 12345)
    _, b = _library(2**31 + 12345)
    _, c = _library(2**31 + 12346)
    fields = ("bases", "quals", "start", "reverse", "indel", "indel_at",
              "damaged", "far", "dup_of")
    assert _digest(*(getattr(a, f) for f in fields)) == \
        _digest(*(getattr(b, f) for f in fields))
    assert _digest(a.bases) != _digest(c.bases)


def test_library_truth_and_recipe():
    g, lib = _library(99, pairs=4000)
    n, l = lib.pairs, lib.read_len
    assert lib.bases.shape == (2, n, l) and l == 150
    # every fragment and far mate lies inside one contig
    for e in (0, 1):
        c = np.searchsorted(g.offsets, lib.start[e], side="right") - 1
        assert (lib.start[e] + l + 8 <= g.ends[c]).all()
    # duplicates are byte copies of an original
    d = np.nonzero(lib.dup_of >= 0)[0]
    assert 0.02 < d.size / n < 0.08
    assert (lib.dup_of[lib.dup_of[d]] == -1).all()
    assert (lib.bases[:, d] == lib.bases[:, lib.dup_of[d]]).all()
    # qualities in the four bins, more low bins at the 3' end
    assert set(np.unique(lib.quals)) <= {2, 12, 23, 37}
    assert (lib.quals[..., -10:] < 37).mean() > (lib.quals[..., :10] < 37).mean()
    # an undamaged, indel-free end matches its truth but for ~1% substitutions
    ok = (lib.indel[0] == 0)
    fwd = np.where(lib.reverse[0][:, None], generator.revcomp(lib.bases[0]),
                   lib.bases[0])
    ref = g.codes[lib.start[0][:, None] + np.arange(l)]
    sel = ok & ~(ref == 4).any(axis=1)
    assert 0.003 < (fwd[sel] != ref[sel]).mean() < 0.015


def test_fastq_bytes():
    bases = np.array([[0, 1, 2, 3, 4]], np.uint8)
    quals = np.array([[37, 23, 12, 2, 0]], np.uint8)
    assert generator.fastq_bytes(bases, quals) == b"@t0\nACGTN\n+\nF8-#!\n"
