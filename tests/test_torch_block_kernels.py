"""The order-keeping add fold and the two block kernels of the port
(``scatter_segments``, ``spmv_block_ell``): their plain versions against
the JAX package's Pallas kernels (interpret mode) and numpy oracles.

* The add fold must be bitwise equal to the reference's serial scatter on
  any device.  Its plain version adds one occurrence rank per pass
  (``ordered_scatter_add``): within a pass no two rows share a slot, so
  the result does not depend on how a device orders a ``scatter_add_``.
  It is held bitwise against ``scatter_add_`` on the CPU (serial there),
  against JAX's ``scatter_body`` and against ``fold_scatter(op="add")`` in
  interpret mode, on inputs with heavy duplication.
* ``scatter_segments``' plain version adds in row order too, so it is
  bitwise equal to the serial ``scatter_ref``; the Pallas kernel sums by
  a one-hot matrix product, so it agrees within the reference's ``1e-5``.
* ``spmv_block_ell``'s plain version agrees with the Pallas kernel and
  ``block_ell_ref`` within the reference's ``1e-4``; the port's vectorized
  ``to_block_ell`` gives the reference's arrays exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.engine import fold_scatter as j_fold_scatter
from repro.kernels.engine.kernel import scatter_body as j_scatter_body
from repro.kernels.scatter_update.kernel import scatter_segments as j_seg
from repro.kernels.scatter_update.ref import scatter_ref as j_scatter_ref
from repro.kernels.spmv.kernel import spmv_block_ell as j_spmv
from repro.kernels.spmv.ref import to_block_ell as j_to_block_ell
from repro_torch.kernels.engine import (fold_scatter, ordered_scatter_add,
                                        scatter_body)
from repro_torch.kernels.scatter_update import (binned_scatter,
                                                scatter_ref,
                                                scatter_segments)
from repro_torch.kernels.spmv import (block_ell_matvec, block_ell_ref,
                                      spmv_block_ell, spmv_dense_ref,
                                      to_block_ell)

pytestmark = pytest.mark.torch_port


def t(a):
    return torch.from_numpy(np.array(a))


def bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def same(a, b, what=""):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape,
                                                       b.shape)
    np.testing.assert_array_equal(bits(a), bits(b), err_msg=what)


# --------------------------------------------------------------------------
# The ordered add (fold_scatter op="add")
# --------------------------------------------------------------------------

def fold_inputs(kind, v_chunk, r, seed, tiles=3):
    """Per-tile fold inputs: ``kind`` picks the duplication pattern."""
    rng = np.random.default_rng(seed)
    tgt = rng.normal(size=(tiles, v_chunk)).astype(np.float32)
    tgt[:, 0] = -0.0  # -0.0 + 0.0 is +0.0: invalid rows must still add 0
    valid = rng.random((tiles, r)) < 0.7
    vals = (rng.normal(size=(tiles, r)) * 10.0 ** rng.integers(
        -3, 4, (tiles, r))).astype(np.float32)  # mixed magnitudes
    if kind == "one-slot":
        lidx = np.where(valid, 1, v_chunk)
    elif kind == "all-invalid":
        valid[:] = False
        lidx = np.full((tiles, r), v_chunk)
    elif kind == "invalid-on-real-slots":
        # invalid rows alone on slots 0/1: slot 0's -0.0 turns +0.0
        lidx = np.where(valid, rng.integers(2, v_chunk, (tiles, r)),
                        rng.integers(0, 2, (tiles, r)))
    else:  # heavy duplication over a quarter of the slots, rest trash
        lidx = np.where(valid, rng.integers(0, max(v_chunk // 4, 1),
                                            (tiles, r)), v_chunk)
    return tgt, lidx.astype(np.int32), vals, valid


ADD_CASES = [("dups", 32, 200), ("dups", 8, 512), ("dups", 128, 1),
             ("one-slot", 16, 300), ("all-invalid", 16, 40),
             ("invalid-on-real-slots", 4, 64)]


@pytest.mark.parametrize("kind,v_chunk,r", ADD_CASES)
def test_ordered_add_fold_bitwise_equals_jax(kind, v_chunk, r):
    tgt, lidx, vals, valid = fold_inputs(kind, v_chunk, r,
                                         seed=v_chunk * 7 + r)
    args = [jnp.asarray(a) for a in (tgt, lidx, vals, valid)]
    j_body = jax.vmap(lambda a, b, c, d: j_scatter_body(a, b, c, d, "add"))(
        *args)
    j_kernel = jax.vmap(lambda a, b, c, d: j_fold_scatter(
        a, b, c, d, op="add"))(*args)
    got = scatter_body(t(tgt), t(lidx), t(vals), t(valid), "add")
    same(j_body, got, "scatter_body")
    same(j_kernel, got, "fold_scatter interpret")
    same(got, fold_scatter(t(tgt), t(lidx), t(vals), t(valid), op="add"),
         "wrapper")
    if kind == "all-invalid":
        same(got, tgt, "all-invalid is the identity")
    if kind == "invalid-on-real-slots":
        assert not torch.signbit(got[:, 0]).any()  # -0.0 + 0.0 = +0.0


@pytest.mark.parametrize("kind,v_chunk,r", ADD_CASES)
def test_ordered_scatter_add_equals_serial_scatter_add(kind, v_chunk, r):
    """The pass-per-rank formulation equals one serial ``scatter_add_``
    (the CPU's) on the same rows, bit for bit."""
    tgt, lidx, vals, valid = fold_inputs(kind, v_chunk, r, seed=r)
    masked = np.where(valid, vals, np.float32(0.0))
    got = ordered_scatter_add(t(tgt), t(lidx), t(masked))  # trash skipped
    serial = torch.cat([t(tgt), torch.zeros((tgt.shape[0], 1))], dim=1)
    serial.scatter_add_(1, t(lidx).to(torch.int64), t(masked))
    same(got, serial[:, :v_chunk], "ordered vs serial")


# --------------------------------------------------------------------------
# scatter_segments (binned T3 scatter)
# --------------------------------------------------------------------------

SEG_CASES = [(4, 128, 32, "mixed"), (2, 64, 128, "mixed"),
             (3, 32, 200, "one-slot"), (2, 64, 16, "empty"),
             (2, 16, 1, "mixed")]


def seg_inputs(nb, b, cap, kind, seed):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(nb, b)).astype(np.float32)
    if kind == "one-slot":
        idx = np.where(rng.random((nb, cap)) < 0.8, 5, -1)
    elif kind == "empty":
        idx = np.full((nb, cap), -1)
    else:
        idx = rng.integers(-1, b, (nb, cap))  # -1 = empty slot
    vals = rng.normal(size=(nb, cap)).astype(np.float32)
    return base, idx.astype(np.int32), vals


@pytest.mark.parametrize("op", ["min", "add"])
@pytest.mark.parametrize("nb,b,cap,kind", SEG_CASES)
def test_scatter_segments_plain_matches_pallas_and_ref(op, nb, b, cap,
                                                       kind):
    base, idx, vals = seg_inputs(nb, b, cap, kind, seed=nb * b + cap)
    got = scatter_segments(t(base), t(idx), t(vals), op=op)
    same(got, binned_scatter(t(base), t(idx), t(vals), op), "wrapper")
    want = j_scatter_ref(base, idx, vals, op)
    same(want, scatter_ref(base, idx, vals, op), "port scatter_ref")
    same(want, got, "serial order")  # bitwise, not just within 1e-5
    pallas = np.asarray(j_seg(jnp.asarray(base), jnp.asarray(idx),
                              jnp.asarray(vals), op=op))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-5, atol=1e-5)
    if kind == "empty":
        same(got, base, "all-empty is the identity")


# --------------------------------------------------------------------------
# spmv_block_ell and to_block_ell
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,nnz,b", [(300, 2000, 64), (513, 4000, 128),
                                     (100, 500, 32), (64, 0, 32)])
def test_spmv_block_ell_plain_matches_pallas_and_ref(n, nnz, b):
    rng = np.random.default_rng(n + nnz)
    rows = rng.integers(0, n, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.normal(size=nnz).astype(np.float32)
    bvals, bcols, n_pad = to_block_ell(n, rows, cols, vals, b)
    for a, c in zip((bvals, bcols, n_pad),
                    j_to_block_ell(n, rows, cols, vals, b)):
        same(c, a, "to_block_ell")
    x = rng.normal(size=n_pad).astype(np.float32)
    x[n:] = 0
    got = spmv_block_ell(t(bvals), t(bcols), t(x))
    same(got, block_ell_matvec(t(bvals), t(bcols), t(x)), "wrapper")
    assert got.dtype == torch.float32 and got.shape == (n_pad,)
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), block_ell_ref(bvals, bcols, x),
                               **tol)
    np.testing.assert_allclose(got.numpy()[:n], spmv_dense_ref(
        n, rows, cols, vals, x[:n]), **tol)
    pallas = np.asarray(j_spmv(jnp.asarray(bvals), jnp.asarray(bcols),
                               jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), pallas, **tol)


def test_to_block_ell_slots_and_duplicates_match_reference():
    """Fixed ``slots`` wider than needed, repeated (row, col) entries added
    in input order, and the too-narrow case raising."""
    rng = np.random.default_rng(5)
    n, nnz, b = 200, 3000, 32
    rows = rng.integers(0, 40, nnz)   # few rows: many repeated entries
    cols = rng.integers(0, n, nnz)
    vals = rng.normal(size=nnz).astype(np.float32)
    width = to_block_ell(n, rows, cols, vals, b)[1].shape[1]
    for a, c in zip(to_block_ell(n, rows, cols, vals, b, slots=width + 3),
                    j_to_block_ell(n, rows, cols, vals, b,
                                   slots=width + 3)):
        same(c, a, "to_block_ell slots")
    with pytest.raises(AssertionError, match="slots"):
        to_block_ell(n, rows, cols, vals, b, slots=width - 1)


def test_block_kernels_count_only_cuda_launches():
    """On CPU tensors the wrappers run their plain versions and leave the
    CUDA launch counters untouched."""
    before = (scatter_segments.launches, spmv_block_ell.launches)
    scatter_segments(torch.zeros((2, 8)), torch.full((2, 3), -1,
                                                     dtype=torch.int32),
                     torch.zeros((2, 3)), op="add")
    spmv_block_ell(torch.zeros((1, 1, 32, 32)),
                   torch.zeros((1, 1), dtype=torch.int32), torch.zeros(32))
    assert (scatter_segments.launches, spmv_block_ell.launches) == before
