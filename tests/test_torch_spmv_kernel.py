"""The block-ELL SpMV kernel's wrapper and, on a card, the kernel itself
against its plain version (``repro_torch.kernels.spmv``).

This file imports no JAX, so the card's machine runs it:
``python -m pytest -q -m cuda tests/test_torch_spmv_kernel.py``.  The
``cuda`` tests skip without a card; the refusals and the work split run
anywhere (refusals on ``meta`` tensors, which take the CUDA path's checks
without one).  Tolerance: the reference's (``tests/test_kernels.py:75``),
``rtol = atol = 1e-4``: the kernel sums a row's slots over several blocks
and then in group order, the plain version in slot order.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.spmv import (block_ell_matvec, spmv_block_ell,
                                      to_block_ell)
from repro_torch.kernels.spmv.kernel import MAX_BLOCK, groups

pytestmark = pytest.mark.torch_port

TOL = dict(rtol=1e-4, atol=1e-4)
# (n, nnz, b): the block phase's kernel cases (chip_smoke.py), then b = 256
COO_CASES = [(300, 2000, 64), (513, 4000, 128), (100, 500, 32), (64, 0, 32),
             (700, 6000, 256)]


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """A non-CPU tensor takes the CUDA path, which checks the block size,
    then every operand's dtype, shape and contiguity and, last, the
    device."""
    bv, bc, x = meta((2, 3, 32, 32)), meta((2, 3), torch.int32), meta((64,))
    for b in (16, 48, 288):
        with pytest.raises(ValueError, match="multiple of 32"):
            spmv_block_ell(meta((2, 3, b, b)), bc, meta((2 * b,)))
    with pytest.raises(TypeError):
        spmv_block_ell(bv.double(), bc, x)
    with pytest.raises(TypeError):
        spmv_block_ell(bv, bc.long(), x)
    with pytest.raises(ValueError, match="shape"):
        spmv_block_ell(bv, meta((2, 4), torch.int32), x)
    with pytest.raises(ValueError, match="shape"):
        spmv_block_ell(bv, bc, meta((96,)))
    with pytest.raises(ValueError, match="contiguous"):
        spmv_block_ell(bv, meta((3, 2), torch.int32).t(), x)
    with pytest.raises(ValueError, match="CUDA"):
        spmv_block_ell(bv, bc, x)
    assert spmv_block_ell.launches == 0


@pytest.mark.parametrize("b", range(32, MAX_BLOCK + 1, 32))
def test_wrapper_takes_every_block_size_it_has_an_instance_for(b):
    """Every multiple of 32 up to 256 passes the checks and stops only at
    the device check."""
    with pytest.raises(ValueError, match="CUDA"):
        spmv_block_ell(meta((2, 3, b, b)), meta((2, 3), torch.int32),
                       meta((2 * b,)))
    assert spmv_block_ell.launches == 0


@pytest.mark.parametrize("NB,S,sms,want", [
    (128, 127, 132, 9),    # R-MAT-14 at b = 128: 1,152 blocks
    (128, 3, 132, 3),      # never more groups than slots
    (2000, 50, 132, 1),    # enough row-blocks already
    (5, 1, 132, 1), (1, 0, 132, 1), (0, 4, 132, 4)])
def test_groups_fill_the_card(NB, S, sms, want):
    G = groups(NB, S, sms)
    assert G == want
    assert 1 <= G <= max(S, 1)


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(0)
    bv = torch.from_numpy(rng.normal(size=(3, 2, 32, 32)).astype(np.float32))
    bc = torch.tensor([[0, -1], [2, 1], [5, -7]], dtype=torch.int32)
    x = torch.from_numpy(rng.normal(size=96).astype(np.float32))
    before = spmv_block_ell.launches
    got = spmv_block_ell(bv, bc, x)
    assert torch.equal(got, block_ell_matvec(bv, bc, x))
    assert spmv_block_ell.launches == before


def coo_case(n, nnz, b, dev):
    rng = np.random.default_rng(n + nnz + b)
    rows, cols = rng.integers(0, n, nnz), rng.integers(0, n, nnz)
    vals = rng.normal(size=nnz).astype(np.float32)
    bv, bc, n_pad = to_block_ell(n, rows, cols, vals, b)
    x = rng.normal(size=n_pad).astype(np.float32)
    return (torch.from_numpy(bv).to(dev), torch.from_numpy(bc).to(dev),
            torch.from_numpy(x).to(dev))


def drawn_case(NB, S, b, bcols, dev, seed=0):
    rng = np.random.default_rng(seed)
    bv = rng.normal(size=(NB, S, b, b)).astype(np.float32)
    x = rng.normal(size=NB * b).astype(np.float32)
    return (torch.from_numpy(bv).to(dev),
            torch.tensor(bcols, dtype=torch.int32, device=dev),
            torch.from_numpy(x).to(dev))


def run_twice(bv, bc, x):
    """Two launches: within TOL of the plain version, bitwise equal to
    each other (the kernel sums in a fixed order and resets its counters),
    one launch counted each."""
    before = spmv_block_ell.launches
    y1 = spmv_block_ell(bv, bc, x)
    y2 = spmv_block_ell(bv, bc, x)
    torch.cuda.synchronize()
    assert spmv_block_ell.launches == before + 2
    assert torch.equal(y1.view(torch.int32), y2.view(torch.int32))
    torch.testing.assert_close(y1, block_ell_matvec(bv, bc, x), **TOL)
    return y1


@pytest.mark.cuda
@pytest.mark.parametrize("n,nnz,b", COO_CASES)
def test_cuda_kernel_matches_plain_on_coo_matrices(n, nnz, b):
    y = run_twice(*coo_case(n, nnz, b, card()))
    if nnz == 0:   # no live slot anywhere: zeros
        assert not y.any()


@pytest.mark.cuda
def test_cuda_every_slot_live_and_out_of_range_slots():
    """Row-block 0 has every slot live; the others mix live slots with -1
    and values outside [0, NB), which are never read."""
    bcols = [[0, 1, 2, 3], [3, -1, 2, -1], [-1, 7, 1, -5], [-1, -1, -1, -1]]
    bv, bc, x = drawn_case(4, 4, 64, bcols, card())
    y = run_twice(bv, bc, x)
    assert not y[3 * 64:].any()   # row-block 3: no live slot


@pytest.mark.cuda
def test_cuda_one_slot_a_row_block():
    bv, bc, x = drawn_case(5, 1, 32, [[4], [0], [-1], [2], [9]], card())
    run_twice(bv, bc, x)


@pytest.mark.cuda
@pytest.mark.parametrize("b", range(32, MAX_BLOCK + 1, 32))
def test_cuda_every_block_size(b):
    """Each instance's thread layout (8, 16 or 32 lanes a row)."""
    bcols = [[1, 0, -1], [2, 2, 0], [-1, 1, 2]]
    run_twice(*drawn_case(3, 3, b, bcols, card(), seed=b))


@pytest.mark.cuda
def test_cuda_misaligned_x_is_read_from_an_aligned_copy():
    dev = card()
    bv, bc, x = drawn_case(2, 2, 32, [[0, 1], [1, -1]], dev)
    x_off = torch.empty(x.numel() + 1, device=dev)[1:]
    x_off.copy_(x)
    assert x_off.data_ptr() % 16
    torch.testing.assert_close(run_twice(bv, bc, x_off),
                               block_ell_matvec(bv, bc, x), **TOL)
