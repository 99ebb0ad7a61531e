"""Hand-written CUDA kernels vs their plain torch versions, on the card.

This file imports no jax, so it also runs on a GPU machine without JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -q -s

(--noconftest skips tests/conftest.py, which configures jax).  Where
torch.cuda.is_available() is False every test here skips.
"""

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
