"""The SSD kernel's wrapper and, on a card, the kernel itself against its
plain version (``repro_torch.kernels.mamba2``).

This file imports no JAX, so the card's machine runs it:
``python -m pytest -q -m cuda tests/test_torch_mamba2_kernel.py``.  The
``cuda`` tests skip without a card (the kernel has no CPU mode); the
refusals run anywhere, on ``meta`` tensors, which take the CUDA path's
checks without one.  Tolerances: y and the final state within REL_TOL of
the largest magnitude of the plain version's output (``ssd_chunked`` at
the same chunk; the two sum in float32 in different orders), and within
the reference's 3e-4 of the step-by-step scan oracle
(``tests/test_kernels.py:180-194``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.mamba2 import (ssd, ssd_chunked, ssd_kernel,
                                        ssd_scan_oracle)
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

REL_TOL = 1e-5
ORACLE_TOL = 3e-4
# (B, S, H, P, N, chunk, a_log, dt): a_log None draws 0.3 N(0, 1) and dt
# None softplus(N(0, 1)), as the reference's sweep; a number fixes them
CASES = [
    (2, 128, 3, 16, 8, 16, None, None),     # the reference's sweep
    (1, 64, 2, 32, 16, 32, None, None),
    (2, 96, 1, 64, 64, 16, None, None),
    (1, 16, 2, 64, 64, 16, None, None),     # one chunk
    (2, 64, 3, 32, 16, 16, 2.0, None),      # most decays at the clip
    (1, 64, 2, 32, 16, 16, None, 1e-5),     # dt -> 0: no decay
    (1, 64, 2, 16, 8, 32, 2.0, 10.0),       # the upper triangle overflows
    (4, 2048, 80, 64, 64, 16, None, None),  # the zamba2-2.7b prefill
    # ragged tiles: chunks of 1, 5 and 8 steps and S = 8 < chunk, padded to
    # the kernel's 8-step tiles; H not a multiple of a block's heads
    (2, 16, 3, 16, 8, 1, None, None),
    (2, 40, 3, 16, 8, 5, None, None),
    (2, 64, 3, 16, 8, 8, None, None),
    (2, 8, 3, 16, 8, 16, None, None),
    (1, 16, 3, 64, 64, 1, None, None),
    (1, 40, 3, 64, 64, 5, None, None),
    (1, 64, 3, 64, 64, 8, None, None),
    (1, 8, 3, 64, 64, 16, None, None),
    (1, 48, 5, 32, 16, 24, None, None),     # three tiles of 8 steps
    # zamba2's 80 heads, the last block of a batch row part idle, over more
    # blocks than an H100 has SMs (135 and 140: a second wave)
    (5, 64, 80, 64, 64, 16, None, None),
    (10, 64, 80, 32, 16, 32, None, None),
]


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def operands(B=2, S=64, H=3, P=32, N=16):
    return (meta((B, S, H, P)), meta((B, S, H)), meta((H,)),
            meta((B, S, N)), meta((B, S, N)))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """A non-CPU tensor takes the CUDA path, which checks every operand
    before any launch: dtype, shape, contiguity, the head and state
    widths, the chunk, S against the chunk and, last, the device."""
    x, dt, al, bm, cm = operands()
    with pytest.raises(TypeError):
        ssd_kernel(x.bfloat16(), dt, al, bm, cm)
    with pytest.raises(TypeError):
        ssd_kernel(x, dt, al, bm, cm, state0=meta((2, 3, 32, 16)).double())
    with pytest.raises(ValueError, match="shape"):
        ssd_kernel(x, meta((2, 64, 4)), al, bm, cm)
    with pytest.raises(ValueError, match="shape"):
        ssd_kernel(x, dt, meta((4,)), bm, cm)
    with pytest.raises(ValueError, match="shape"):
        ssd_kernel(x, dt, al, bm, cm, state0=meta((2, 3, 16, 32)))
    with pytest.raises(ValueError, match="contiguous"):
        ssd_kernel(x, dt, al, bm, meta((2, 16, 64)).transpose(1, 2))
    with pytest.raises(ValueError, match="head width"):
        ssd_kernel(*operands(P=48))
    with pytest.raises(ValueError, match="state width"):
        ssd_kernel(*operands(N=24))
    with pytest.raises(ValueError, match="chunk"):
        ssd_kernel(x, dt, al, bm, cm, chunk=64)
    with pytest.raises(ValueError, match="chunk"):
        ssd_kernel(x, dt, al, bm, cm, chunk=0)
    with pytest.raises(ValueError, match="multiple"):   # 200 % 16 != 0
        ssd_kernel(*operands(S=200))
    with pytest.raises(ValueError, match="multiple"):
        ssd(*operands(S=200))
    assert ssd_kernel.launches == 0


@pytest.mark.parametrize("S,chunk", [(16, 16), (208, 16), (8, 16),
                                     (2048, 16), (64, 32)])
def test_wrapper_takes_the_lengths_the_reference_takes(S, chunk):
    """An S that divides into chunks of min(chunk, S), as the reference's
    ``ssd_chunked`` asserts, passes every shape check and stops only at
    the device check; so do zamba2-2.7b's widths (H 80, P 64, N 64)."""
    with pytest.raises(ValueError, match="CUDA"):
        ssd_kernel(*operands(S=S, H=80, P=64, N=64), chunk=chunk)
    assert ssd_kernel.launches == 0


def draw(dev, B, S, H, P, N, seed, a_log=None, dt=None, state=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P))
    dts = np.logaddexp(rng.normal(size=(B, S, H)), 0.0) if dt is None \
        else np.full((B, S, H), dt)
    al = 0.3 * rng.normal(size=(H,)) if a_log is None else \
        np.full((H,), a_log)
    bm, cm = rng.normal(size=(B, S, N)), rng.normal(size=(B, S, N))
    s0 = rng.normal(size=(B, H, P, N)) if state else None
    return [None if a is None else
            torch.from_numpy(np.asarray(a, np.float32)).to(dev)
            for a in (x, dts, al, bm, cm, s0)]


def close_to_max(got, want, tol, what):
    torch.testing.assert_close(got, want, rtol=tol,
                               atol=tol * float(want.abs().max()), msg=what)


@pytest.mark.parametrize("B,S,H,P,N,chunk,a_log,dt",
                         [c for c in CASES if c[1] <= 128])
def test_state_rows_are_independent(B, S, H, P, N, chunk, a_log, dt):
    """The premise of the kernel's split of the state along P: the plain
    version on 16-row slices of x and of state0, concatenated, equals the
    whole call within 1e-6 of the largest magnitude (y[t][p] reads only
    S[p][:] and x[:, p]; S[p][:] is updated only from x[:, p])."""
    x, dts, al, bm, cm, s0 = draw("cpu", B, S, H, P, N, S + P, a_log, dt,
                                  state=True)
    y, s = ssd_chunked(x, dts, al, bm, cm, state0=s0, chunk=chunk)
    parts = [ssd_chunked(x[..., p:p + 16].contiguous(), dts, al, bm, cm,
                         state0=s0[:, :, p:p + 16].contiguous(), chunk=chunk)
             for p in range(0, P, 16)]
    close_to_max(torch.cat([a for a, _ in parts], -1), y, 1e-6, "y")
    close_to_max(torch.cat([b for _, b in parts], -2), s, 1e-6, "state")


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,P,N,chunk,a_log,dt", CASES)
def test_cuda_kernel_matches_plain(B, S, H, P, N, chunk, a_log, dt):
    dev = card()
    x, dts, al, bm, cm, _ = draw(dev, B, S, H, P, N, S + P, a_log, dt)
    before = ssd_kernel.launches
    y, s = ssd_kernel(x, dts, al, bm, cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_kernel.launches == before + 1
    assert bool(torch.isfinite(y).all() and torch.isfinite(s).all())
    py, ps = ssd_chunked(x, dts, al, bm, cm, chunk=chunk)
    close_to_max(y, py, REL_TOL, "y vs plain")
    close_to_max(s, ps, REL_TOL, "state vs plain")
    if S <= 128:
        oy, os_ = ssd_scan_oracle(x, dts, al, bm, cm)
        torch.testing.assert_close(y, oy, rtol=ORACLE_TOL, atol=ORACLE_TOL)
        torch.testing.assert_close(s, os_, rtol=ORACLE_TOL,
                                   atol=ORACLE_TOL)


@pytest.mark.cuda
def test_cuda_kernel_carries_the_state():
    """One call equals two halves, the second from the first's state; a
    non-zero state0 matches the plain version."""
    dev = card()
    x, dts, al, bm, cm, s0 = draw(dev, 2, 128, 4, 64, 64, 7, state=True)
    y_full, s_full = ssd_kernel(x, dts, al, bm, cm)
    h = 64
    y1, s1 = ssd_kernel(*(a[:, :h].contiguous() for a in (x, dts)), al,
                        *(a[:, :h].contiguous() for a in (bm, cm)))
    y2, s2 = ssd_kernel(*(a[:, h:].contiguous() for a in (x, dts)), al,
                        *(a[:, h:].contiguous() for a in (bm, cm)),
                        state0=s1)
    close_to_max(torch.cat([y1, y2], 1), y_full, REL_TOL, "carried y")
    close_to_max(s2, s_full, REL_TOL, "carried state")
    y, s = ssd_kernel(x, dts, al, bm, cm, state0=s0)
    py, ps = ssd_chunked(x, dts, al, bm, cm, state0=s0, chunk=16)
    close_to_max(y, py, REL_TOL, "state0 y vs plain")
    close_to_max(s, ps, REL_TOL, "state0 state vs plain")


@pytest.mark.cuda
def test_cuda_kernel_takes_operands_off_their_alignment():
    """x, B, C and state0 as views that start 4 bytes into their storage:
    the kernel copies x, B and C in 16-byte pieces and state0 in 8, so the
    wrapper copies such operands first.  The outputs are bitwise those of
    the aligned call, and match the plain version."""
    dev = card()
    x, dts, al, bm, cm, s0 = draw(dev, 2, 64, 5, 32, 16, 11, state=True)

    def shifted(t):
        view = torch.empty(t.numel() + 1, device=dev)[1:].view(t.shape)
        return view.copy_(t)

    xs, bs, cs, ss = (shifted(a) for a in (x, bm, cm, s0))
    assert all(a.data_ptr() % 16 == 4 for a in (xs, bs, cs, ss))
    before = ssd_kernel.launches
    y, s = ssd_kernel(xs, dts, al, bs, cs, state0=ss)
    assert ssd_kernel.launches == before + 1
    ya, sa = ssd_kernel(x, dts, al, bm, cm, state0=s0)
    assert torch.equal(y, ya) and torch.equal(s, sa)
    py, ps = ssd_chunked(x, dts, al, bm, cm, state0=s0, chunk=16)
    close_to_max(y, py, REL_TOL, "shifted y vs plain")
    close_to_max(s, ps, REL_TOL, "shifted state vs plain")
