"""Port's single-end device pipeline vs JAX `align_batch_jit`, field by field.

Same keys, same dtypes.  Integer and bool fields must be equal; the f32
log-prob sums may differ in reduction order (rtol 1e-5); MAPQ may differ
only by floor flips (+-1 on at most max(2, 0.5%) of rows), the tolerance
pattern of tests/test_parity_oracle.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_fixture
from isaac_aligner_tpu.align import pipeline as jpipe
from isaac_aligner_tpu.index.build import build_index
from isaac_aligner_tpu_torch import synthetic
from isaac_aligner_tpu_torch.align import pipeline as tpipe

FLOAT_FIELDS = ("log_prob", "others_sum", "log_scale")


def _to_port_cfg(cfg):
    return tpipe.AlignConfig(**dataclasses.asdict(cfg))


def rich_fixture(n_reads=128, seed=7):
    """Two contigs, a 14-copy repeat family above the repeat threshold, 3
    identical copies (exact score ties), an N island, indel reads, random
    qualities with low-quality tails and a few adapter-masked tails."""
    rng = np.random.default_rng(seed)
    genome = synthetic.make_genome(rng, 30_000,
                                   families=((300, 14, 0.01), (150, 3, 0.0)),
                                   n_island=(20_000, 200), n_contigs=2)
    index = build_index(genome, seed_len=32)
    sim = synthetic.make_reads(rng, genome.codes, n_reads, indel_frac=0.15)
    quals = rng.integers(20, 41, sim.bases.shape).astype(np.uint8)
    for i in np.nonzero(rng.random(n_reads) < 0.25)[0]:
        t = int(rng.integers(10, 40))
        quals[i, -t:] = rng.integers(2, 12, t)
    tail = np.where(rng.random(n_reads) < 0.1, 5, 0).astype(np.int32)
    bw, bl = jpipe.bucket_params_for(index)
    cfg = jpipe.AlignConfig(
        seed_len=32, seed_offsets=jpipe.default_seed_offsets(100, 32),
        bucket_width=bw, bucket_log2=bl, genome_has_n=True,
        genome_len=genome.total_length, quality_trim_cutoff=25,
        semialigned_clip=True)
    return index, sim, sim.bases, quals, tail, cfg


def _run_both(index, bases, quals, cfg, tail=None):
    arrays = jpipe.prepare_index(index, upload_codes=cfg.genome_len == 0)
    ref = jax.device_get(jpipe.align_batch_jit(
        arrays, jnp.asarray(bases), jnp.asarray(quals), cfg,
        None if tail is None else jnp.asarray(tail)))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    tarr = tpipe.prepare_index(index, "cpu", upload_codes=cfg.genome_len == 0)
    out = tpipe.align_batch(tarr, torch.from_numpy(bases),
                            torch.from_numpy(quals), _to_port_cfg(cfg),
                            None if tail is None else torch.from_numpy(tail))
    return ref, {k: v.numpy() for k, v in out.items()}


def assert_fields_match(ref, out):
    assert sorted(out) == sorted(ref)
    for k in sorted(ref):
        a, e = out[k], ref[k]
        assert a.dtype == e.dtype, (k, a.dtype, e.dtype)
        assert a.shape == e.shape, (k, a.shape, e.shape)
        if k in FLOAT_FIELDS:
            np.testing.assert_allclose(a, e, rtol=1e-5, err_msg=k)
        elif k != "mapq":
            np.testing.assert_array_equal(a, e, err_msg=k)
    diff = np.abs(out["mapq"].astype(np.int64) - ref["mapq"].astype(np.int64))
    assert diff.max(initial=0) <= 1, "MAPQ differs beyond a floor flip"
    assert int((diff > 0).sum()) <= max(2, int(0.005 * diff.size))


@pytest.mark.parametrize("case", ["tiny", "rich", "rich_tight_caps"])
def test_align_batch_matches_jax(case):
    if case == "tiny":
        index, bases, quals, cfg = _tiny_fixture()
        tail = None
    else:
        index, _sim, bases, quals, tail, cfg = rich_fixture()
        if case == "rich_tight_caps":
            # small capacities: candidate/scoring overflow, dropped pass-2
            # escalations and the dodgy MAPQ path all fire
            cfg = dataclasses.replace(
                cfg, max_candidates=8, max_scored_candidates=4,
                scored_pairs_per_read=1, second_pass_fraction=0.1,
                dodgy_mapq=3)
    ref, out = _run_both(index, bases, quals, cfg, tail)
    assert_fields_match(ref, out)
    assert out["aligned"].sum() > 0.8 * len(bases)
    if case == "rich":
        assert out["qtrim"].any() and out["sa_do"].any()
        assert int(out["seeds_too_many"]) > 0       # repeat-suppressed seeds
        assert (out["mismatches"] > 5).any()         # indel reads
    if case == "rich_tight_caps":
        assert int(out["pass2_dropped"]) > 0
        assert out["candidate_overflow"].any()


def test_dedup_candidates_matches_jax():
    rng = np.random.default_rng(3)
    b, h = 32, 80
    start = rng.integers(-60, 40, (b, h)).astype(np.int32)   # many duplicates
    orient = rng.integers(0, 2, (b, h)).astype(np.int32)
    valid = rng.random((b, h)) < 0.6
    clean = rng.random((b, h)) < 0.5
    ref = jpipe.dedup_candidates(jnp.asarray(start), jnp.asarray(orient),
                                 jnp.asarray(valid), jnp.asarray(clean), 32)
    out = tpipe.dedup_candidates(torch.from_numpy(start),
                                 torch.from_numpy(orient),
                                 torch.from_numpy(valid),
                                 torch.from_numpy(clean), 32)
    for a, e in zip(out[:5], ref[:5]):
        assert a.numpy().dtype == np.asarray(e).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(e))
    for k in ("num_candidates", "candidate_overflow"):
        np.testing.assert_array_equal(out[5][k].numpy(), np.asarray(ref[5][k]))


@pytest.mark.parametrize("size", [1, 7, 40])
def test_compact_indices_is_fixed_size_nonzero(size):
    rng = np.random.default_rng(size)
    mask = rng.random(40) < 0.3
    (want,) = jnp.nonzero(jnp.asarray(mask), size=size, fill_value=40)
    got = tpipe._compact_indices(torch.from_numpy(mask), size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
