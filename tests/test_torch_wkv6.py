"""The port's WKV6 recurrence (``repro_torch.kernels.rwkv6``) against the
JAX package's Pallas ``wkv6_pallas`` (interpret mode, as
``tests/test_kernels.py`` runs it) and its ``ref`` functions, on the same
inputs drawn with numpy.

Cases: the reference's sweep and state-carry case
(``tests/test_kernels.py:142-176``), a prompt shorter than the chunk
(S = 8, C = 8), a non-zero ``state0`` and every decay at the clip, w_log =
-4.  Tolerances:

- against the JAX chunked form and the Pallas kernel at the same chunk:
  within CHUNKED_TOL[chunk] of the largest magnitude of the compared
  output (plus the same relative term).  Both sum in float32 in different
  orders; the cumsum L reaches about chunk x |w|, and its rounding, an
  absolute error of ulp(|L|) (2**-19 ~ 1.9e-6 for |L| in [16, 32)),
  becomes a relative error of exp(+-L), so the bound grows with the chunk
  (measured: at most 0.92 of the bound at chunk 16, 2.1e-6 at chunk 32);
- against the step-by-step scan oracles: the reference's 3e-4.

On the CPU, ``wkv6_kernel`` runs its plain version and launches nothing;
its CUDA path's refusals are checked here on ``meta`` tensors.  The CUDA
kernel itself is tested in ``tests/test_torch_wkv6_kernel.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6 import ops as j_ops
from repro.kernels.rwkv6 import ref as j_ref
from repro.kernels.rwkv6.kernel import wkv6_pallas
from repro_torch.kernels.rwkv6 import kernel as W6K
from repro_torch.kernels.rwkv6 import (wkv6, wkv6_chunked, wkv6_kernel,
                                       wkv6_scan_oracle, wkv6_step)

pytestmark = pytest.mark.torch_port

CHUNKED_TOL = {8: 1e-6, 16: 1e-6, 32: 4e-6}
ORACLE_TOL = 3e-4
# (B, S, H, K, chunk, w_log): None draws clip(-exp(0.5 N(0, 1))), as the
# reference's sweep; a number fixes every decay
CASES = {
    "sweep-16": (2, 128, 3, 16, 16, None),
    "sweep-32": (1, 64, 2, 32, 32, None),
    "sweep-64": (2, 96, 1, 64, 16, None),
    "S8": (1, 8, 2, 64, 16, None),
    "w-4": (1, 64, 2, 64, 16, -4.0),
}


def draw(B, S, H, K, seed, w_fixed=None, state=False):
    """r, k, v ~ N(0, 1), w_log, u ~ 0.5 N(0, 1), and state0 ~ N(0, 1)
    when ``state``, as numpy float32 arrays."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, S, H, K)).astype(np.float32)
               for _ in range(3))
    w = np.clip(-np.exp(0.5 * rng.normal(size=(B, S, H, K))), -4.0, -1e-6)
    if w_fixed is not None:
        w = np.full_like(w, w_fixed)
    u = 0.5 * rng.normal(size=(H, K))
    s0 = rng.normal(size=(B, H, K, K)) if state else None
    return [None if a is None else np.asarray(a, np.float32)
            for a in (r, k, v, w, u, s0)]


def to_jax(arrs):
    return [None if a is None else jnp.asarray(a) for a in arrs]


def to_torch(arrs):
    return [None if a is None else torch.from_numpy(a) for a in arrs]


def close_to_max(got, want, tol, what):
    """Within ``tol`` of the largest magnitude of ``want`` (and ``tol``
    relative)."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol,
                               atol=tol * np.abs(want).max(), err_msg=what)


def oracle_close(got, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=ORACLE_TOL, atol=ORACLE_TOL,
                               err_msg=what)


@pytest.mark.parametrize("case", list(CASES))
def test_chunked_and_wrapper_match_pallas_and_ref(case):
    B, S, H, K, chunk, w_fixed = CASES[case]
    arrs = draw(B, S, H, K, S + K, w_fixed)
    jr, jk, jv, jw, ju, _ = to_jax(arrs)
    tr, tk, tv, tw, tu, _ = to_torch(arrs)
    want = {"pallas": wkv6_pallas(jr, jk, jv, jw, ju, chunk=chunk),
            "chunked": j_ref.wkv6_chunked(jr, jk, jv, jw, ju, chunk=chunk)}
    j_oracle = j_ref.wkv6_scan_oracle(jr, jk, jv, jw, ju)
    got = {"wkv6_chunked": wkv6_chunked(tr, tk, tv, tw, tu, chunk=chunk),
           "wkv6_kernel": wkv6_kernel(tr, tk, tv, tw, tu, chunk=chunk),
           "ops kernel": wkv6(tr, tk, tv, tw, tu, chunk=chunk),
           "ops plain": wkv6(tr, tk, tv, tw, tu, use_kernel=False,
                             chunk=chunk)}
    for name, (y, s) in got.items():
        assert y.dtype == s.dtype == torch.float32
        assert y.shape == (B, S, H, K) and s.shape == (B, H, K, K)
        for wname, (wy, ws) in want.items():
            close_to_max(y, wy, CHUNKED_TOL[min(chunk, S)],
                         f"{name} y vs {wname}")
            close_to_max(s, ws, CHUNKED_TOL[min(chunk, S)],
                         f"{name} state vs {wname}")
        oracle_close(y, j_oracle[0], f"{name} y vs the JAX oracle")
        oracle_close(s, j_oracle[1], f"{name} state vs the JAX oracle")
    ty, ts = wkv6_scan_oracle(tr, tk, tv, tw, tu)
    oracle_close(ty, j_oracle[0], "port oracle y")
    oracle_close(ts, j_oracle[1], "port oracle state")
    assert wkv6_kernel.launches == 0   # CPU tensors: no launch


def test_state_carry_and_nonzero_state0():
    """Splitting a sequence across two calls (the second from the first's
    state) equals one call (the reference's state-carry case); a non-zero
    state0 matches the JAX package's."""
    B, S, H, K = 1, 64, 2, 16
    arrs = draw(B, S, H, K, 7, state=True)
    jr, jk, jv, jw, ju, js = to_jax(arrs)
    tr, tk, tv, tw, tu, ts0 = to_torch(arrs)
    y_full, s_full = wkv6_kernel(tr, tk, tv, tw, tu, chunk=16)
    h = S // 2
    y1, s1 = wkv6_kernel(tr[:, :h], tk[:, :h], tv[:, :h], tw[:, :h], tu,
                         chunk=16)
    y2, s2 = wkv6_kernel(tr[:, h:], tk[:, h:], tv[:, h:], tw[:, h:], tu,
                         state0=s1, chunk=16)
    close_to_max(torch.cat([y1, y2], 1), y_full.numpy(), CHUNKED_TOL[16],
                 "carried y")
    close_to_max(s2, s_full.numpy(), CHUNKED_TOL[16], "carried state")
    jy, jsT = wkv6_pallas(jr, jk, jv, jw, ju, state0=js, chunk=16)
    y, sT = wkv6_kernel(tr, tk, tv, tw, tu, state0=ts0, chunk=16)
    close_to_max(y, jy, CHUNKED_TOL[16], "state0 y vs Pallas")
    close_to_max(sT, jsT, CHUNKED_TOL[16], "state0 state vs Pallas")
    oy, os_ = j_ref.wkv6_scan_oracle(jr, jk, jv, jw, ju, state0=js)
    oracle_close(y, oy, "state0 y vs the JAX oracle")
    oracle_close(sT, os_, "state0 state vs the JAX oracle")


def test_decode_step_matches_the_reference():
    """One step with a state: ``wkv6_step`` and the ops decode path (no
    kernel) against the JAX package's."""
    B, H, K = 2, 3, 32
    arrs = draw(B, 1, H, K, 11, state=True)
    jr, jk, jv, jw, ju, js = to_jax(arrs)
    tr, tk, tv, tw, tu, ts0 = to_torch(arrs)
    jy, jsT = j_ops.wkv6(jr, jk, jv, jw, ju, state0=js)
    y, sT = wkv6(tr, tk, tv, tw, tu, state0=ts0)
    close_to_max(y, jy, 1e-6, "decode y")
    close_to_max(sT, jsT, 1e-6, "decode state")
    s1, y1 = wkv6_step(ts0, tr[:, 0], tk[:, 0], tv[:, 0],
                       torch.exp(tw[:, 0]), tu)
    assert torch.equal(y1, y[:, 0]) and torch.equal(s1, sT)
    assert wkv6_kernel.launches == 0


def meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """A non-CPU tensor takes the CUDA path, which checks every operand
    before any launch: dtype, shape, contiguity, the head width K, the
    chunk, S against the chunk and, last, the device."""
    x, u = meta((2, 64, 3, 32)), meta((3, 32))
    with pytest.raises(TypeError):
        wkv6_kernel(x.bfloat16(), x, x, x, u)
    with pytest.raises(TypeError):
        wkv6_kernel(x, x, x, x, u, state0=meta((2, 3, 32, 32)).double())
    with pytest.raises(ValueError, match="shape"):
        wkv6_kernel(x, meta((2, 32, 3, 32)), x, x, u)
    with pytest.raises(ValueError, match="shape"):
        wkv6_kernel(x, x, x, x, meta((3, 16)))
    with pytest.raises(ValueError, match="contiguous"):
        wkv6_kernel(x, x, meta((2, 3, 64, 32)).transpose(1, 2), x, u)
    y = meta((2, 64, 3, 48))
    with pytest.raises(ValueError, match="head width"):
        wkv6_kernel(y, y, y, y, meta((3, 48)))
    with pytest.raises(ValueError, match="chunk"):
        wkv6_kernel(x, x, x, x, u, chunk=64)
    z = meta((2, 40, 3, 32))
    with pytest.raises(ValueError, match="multiple"):
        wkv6_kernel(z, z, z, z, u, chunk=16)
    with pytest.raises(ValueError, match="CUDA"):
        wkv6_kernel(x, x, x, x, u)
    with pytest.raises(ValueError, match="CUDA"):   # C = S = 8
        wkv6_kernel(*(meta((1, 8, 3, 32)),) * 4, u, chunk=16)
    assert wkv6_kernel.launches == 0


@pytest.mark.parametrize("K", W6K.HEAD_DIMS)
def test_kernel_shared_memory_fits_every_chunk(K):
    """The kernel's dynamic shared memory a block (``smem_bytes``, the
    mirror of ``Layout<K, KT>::WORDS`` in ``csrc/wkv6.cu``, which the card
    tests hold against the compiled value) stays within the 227 KiB a
    block may opt in to for every chunk the wrapper takes, and changes
    only where a chunk takes another tile count (8 and 16 steps)."""
    sizes = [W6K.smem_bytes(K, C) for C in range(1, W6K.MAX_CHUNK + 1)]
    assert max(sizes) <= W6K.SMEM_LIMIT == 227 * 1024
    assert [len(set(sizes[a:b])) for a, b in ((0, 8), (8, 16), (16, 32))] \
        == [1, 1, 1]
    assert sizes[0] < sizes[8] < sizes[16]
