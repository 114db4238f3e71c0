"""The port's Mamba2 SSD recurrence (``repro_torch.kernels.mamba2``) against
the JAX package's Pallas ``ssd_pallas`` (interpret mode, as
``tests/test_kernels.py`` runs it) and its ``ref`` functions, on the same
inputs drawn with numpy.

Cases: the reference's sweep (``tests/test_kernels.py:180-182``), each
also from a non-zero ``state0``, one chunk (S = 16), every log decay at
the clip (a_log = 2: -e^2 dt < -4 wherever dt > 0.55) and no decay (dt
-> 0), and a chunk-32 case whose upper triangle overflows.  Tolerances:

- against the JAX chunked form and the Pallas kernel at the same chunk:
  within CHUNKED_TOL[chunk] of the largest magnitude of the compared
  output (plus the same relative term).  Both sum in float32 in different
  orders, and torch's CPU cumsum accumulates L in float64, so L differs by
  up to ulp(|L|), a relative error of the decays exp(L_t - L_s); |L|
  reaches about 22 at chunk 32 in the sweep (measured: at most 6.4e-7 of
  the largest magnitude at chunk 16, 1.6e-6 at chunk 32, on the state);
- against the step-by-step scan oracles: the reference's 3e-4.

On the CPU, ``ssd_kernel`` runs its plain version and launches nothing;
its CUDA path's refusals are checked on ``meta`` tensors in
``tests/test_torch_mamba2_kernel.py``, which also holds the CUDA kernel
against its plain version on a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba2 import ops as j_ops
from repro.kernels.mamba2 import ref as j_ref
from repro.kernels.mamba2.kernel import ssd_pallas
from repro_torch.kernels.mamba2 import (ssd, ssd_chunked, ssd_kernel,
                                        ssd_scan_oracle, ssd_step)
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

CHUNKED_TOL = {16: 1e-6, 32: 4e-6}
ORACLE_TOL = 3e-4
# (B, S, H, P, N, chunk, dt): None draws softplus(N(0, 1)), as the
# reference's sweep; "tiny" scales it by 1e-4 (no decay)
CASES = {
    "sweep-16x8": (2, 128, 3, 16, 8, 16, None),
    "sweep-32x16": (1, 64, 2, 32, 16, 32, None),
    "sweep-64x64": (2, 96, 1, 64, 64, 16, None),
    "S16": (1, 16, 2, 64, 64, 16, None),
    "dt-tiny": (1, 64, 2, 32, 16, 16, "tiny"),
}


def draw(B, S, H, P, N, seed, dt_kind=None, state=False, a_log=None):
    """x, B, C ~ N(0, 1); dt = softplus(N(0, 1)); a_log ~ 0.3 N(0, 1) (or
    the given value); state0 ~ N(0, 1) when ``state``: numpy float32."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P))
    dt = np.logaddexp(rng.normal(size=(B, S, H)), 0.0)
    if dt_kind == "tiny":
        dt = 1e-4 * dt
    al = 0.3 * rng.normal(size=(H,)) if a_log is None else \
        np.full((H,), a_log)
    bm, cm = rng.normal(size=(B, S, N)), rng.normal(size=(B, S, N))
    s0 = rng.normal(size=(B, H, P, N)) if state else None
    return [None if a is None else np.asarray(a, np.float32)
            for a in (x, dt, al, bm, cm, s0)]


def to_jax(arrs):
    return [None if a is None else jnp.asarray(a) for a in arrs]


def to_torch(arrs):
    return [None if a is None else torch.from_numpy(a) for a in arrs]


def close_to_max(got, want, tol, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol,
                               atol=tol * np.abs(want).max(), err_msg=what)


def oracle_close(got, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=ORACLE_TOL, atol=ORACLE_TOL,
                               err_msg=what)


def check_case(arrs, chunk):
    """Every port form against the JAX chunked form, Pallas (interpret
    mode) and the JAX scan oracle; the port's oracle against the JAX
    oracle."""
    jx, jdt, ja, jb, jc, js = to_jax(arrs)
    tx, tdt, ta, tb, tc, ts = to_torch(arrs)
    B, S, H, P = tx.shape
    N = tb.shape[-1]
    want = {"pallas": ssd_pallas(jx, jdt, ja, jb, jc, state0=js,
                                 chunk=chunk),
            "chunked": j_ref.ssd_chunked(jx, jdt, ja, jb, jc, state0=js,
                                         chunk=chunk)}
    j_oracle = j_ref.ssd_scan_oracle(jx, jdt, ja, jb, jc, state0=js)
    got = {"ssd_chunked": ssd_chunked(tx, tdt, ta, tb, tc, state0=ts,
                                      chunk=chunk),
           "ssd_kernel": ssd_kernel(tx, tdt, ta, tb, tc, state0=ts,
                                    chunk=chunk),
           "ops kernel": ssd(tx, tdt, ta, tb, tc, state0=ts, chunk=chunk),
           "ops plain": ssd(tx, tdt, ta, tb, tc, state0=ts,
                            use_kernel=False, chunk=chunk)}
    for name, (y, s) in got.items():
        assert y.dtype == s.dtype == torch.float32
        assert y.shape == (B, S, H, P) and s.shape == (B, H, P, N)
        assert bool(torch.isfinite(y).all() and torch.isfinite(s).all())
        for wname, (wy, ws) in want.items():
            close_to_max(y, wy, CHUNKED_TOL[chunk], f"{name} y vs {wname}")
            close_to_max(s, ws, CHUNKED_TOL[chunk],
                         f"{name} state vs {wname}")
        oracle_close(y, j_oracle[0], f"{name} y vs the JAX oracle")
        oracle_close(s, j_oracle[1], f"{name} state vs the JAX oracle")
    oy, os_ = ssd_scan_oracle(tx, tdt, ta, tb, tc, state0=ts)
    oracle_close(oy, j_oracle[0], "port oracle y")
    oracle_close(os_, j_oracle[1], "port oracle state")
    assert ssd_kernel.launches == 0   # CPU tensors: no launch


@pytest.mark.parametrize("state", [False, True], ids=["zero", "state0"])
@pytest.mark.parametrize("case", list(CASES))
def test_chunked_and_wrapper_match_pallas_and_ref(case, state):
    B, S, H, P, N, chunk, dt_kind = CASES[case]
    check_case(draw(B, S, H, P, N, S + P, dt_kind, state), chunk)


def test_every_decay_at_the_clip():
    """a_log = 2: -e^2 dt reaches the clip -4 wherever dt > 0.55, so most
    steps forget their state (e^-4 a step)."""
    arrs = draw(2, 64, 3, 32, 16, 21, a_log=2.0, state=True)
    check_case(arrs, 16)


def test_chunk_32_whose_upper_triangle_overflows():
    """dt large and a_log = 2: every step at the clip, so above the
    diagonal exp(L_t - L_s) reaches e^124 = inf in float32 at chunk 32.
    The triangle is selected away, so every output is finite."""
    arrs = draw(1, 64, 2, 16, 8, 23, a_log=2.0)
    arrs[1] = np.full_like(arrs[1], 10.0)
    L = np.cumsum(np.clip(-np.exp(2.0) * arrs[1][0, :32, 0], -4, 0))
    with np.errstate(over="ignore"):
        assert np.isinf(np.exp(np.float32(L[0] - L[-1])))
    check_case(arrs, 32)


def test_state_carry_across_two_calls():
    """Splitting a sequence across two calls (the second from the first's
    state) equals one call."""
    tx, tdt, ta, tb, tc, _ = to_torch(draw(2, 128, 3, 32, 16, 7))
    y_full, s_full = ssd_kernel(tx, tdt, ta, tb, tc)
    h = 64
    y1, s1 = ssd_kernel(tx[:, :h], tdt[:, :h], ta, tb[:, :h], tc[:, :h])
    y2, s2 = ssd_kernel(tx[:, h:], tdt[:, h:], ta, tb[:, h:], tc[:, h:],
                        state0=s1)
    close_to_max(torch.cat([y1, y2], 1), y_full.numpy(), CHUNKED_TOL[16],
                 "carried y")
    close_to_max(s2, s_full.numpy(), CHUNKED_TOL[16], "carried state")


def test_decode_step_matches_the_reference():
    """One step with a state: ``ssd_step`` and the ops decode path (no
    kernel) against the JAX package's."""
    arrs = draw(2, 1, 3, 32, 16, 11, state=True)
    jx, jdt, ja, jb, jc, js = to_jax(arrs)
    tx, tdt, ta, tb, tc, ts = to_torch(arrs)
    jy, jsT = j_ops.ssd(jx, jdt, ja, jb, jc, state0=js)
    y, sT = ssd(tx, tdt, ta, tb, tc, state0=ts)
    close_to_max(y, jy, 1e-6, "decode y")
    close_to_max(sT, jsT, 1e-6, "decode state")
    s1, y1 = ssd_step(ts, tx[:, 0], tdt[:, 0], ta, tb[:, 0], tc[:, 0])
    js1, jy1 = j_ref.ssd_step(js, jx[:, 0], jdt[:, 0], ja, jb[:, 0],
                              jc[:, 0])
    assert torch.equal(y1, y[:, 0]) and torch.equal(s1, sT)
    close_to_max(y1, jy1, 1e-6, "ssd_step y")
    close_to_max(s1, js1, 1e-6, "ssd_step state")
    assert ssd_kernel.launches == 0


def test_plain_version_refuses_what_the_reference_asserts():
    """S = 40 is not a multiple of min(16, 40): the reference's
    ``ssd_chunked`` asserts, the port's raises ValueError on both
    paths."""
    tx, tdt, ta, tb, tc, _ = to_torch(draw(1, 40, 2, 16, 8, 3))
    jx, jdt, ja, jb, jc, _ = to_jax(draw(1, 40, 2, 16, 8, 3))
    with pytest.raises(AssertionError):
        j_ref.ssd_chunked(jx, jdt, ja, jb, jc, chunk=16)
    for use in (True, False):
        with pytest.raises(ValueError, match="multiple"):
            ssd(tx, tdt, ta, tb, tc, use_kernel=use)
