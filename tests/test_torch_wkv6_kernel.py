"""The WKV6 kernel (``repro_torch.kernels.rwkv6``) against its plain
version on a card.

This file imports no JAX, so the card's machine runs it:
``python -m pytest -q -m cuda tests/test_torch_wkv6_kernel.py``.  Every
test skips without a card (the kernel has no CPU mode; the wrapper's
refusals are checked on ``meta`` tensors in ``tests/test_torch_wkv6.py``).
Tolerances: y and the final state within REL_TOL of the largest magnitude
of the plain version's output (``wkv6_chunked`` at the same chunk; the two
sum in float32 in different orders), and within the reference's 3e-4 of
the step-by-step scan oracle (``tests/test_kernels.py:142-176``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.rwkv6 import kernel as W6K
from repro_torch.kernels.rwkv6 import (wkv6_chunked, wkv6_kernel,
                                       wkv6_scan_oracle)

pytestmark = [pytest.mark.torch_port, pytest.mark.cuda]

REL_TOL = 1e-5
ORACLE_TOL = 3e-4
# (B, S, H, K, chunk, w_log): None draws clip(-exp(0.5 N(0, 1))), as the
# reference's sweep; a number fixes every decay
CASES = [
    (2, 128, 3, 16, 16, None),     # the reference's sweep
    (1, 64, 2, 32, 32, None),
    (2, 96, 1, 64, 16, None),
    (1, 8, 2, 64, 16, None),       # S < chunk: C = S = 8
    (1, 64, 2, 64, 16, -4.0),      # every decay at the clip
    (1, 64, 2, 64, 16, -1e-6),     # no decay
    (4, 2048, 32, 64, 16, None),   # the rwkv6-1.6b prefill
    # K = 16 and 32 over 512 steps at C = 8, 16 and 32 (the kernel's 1, 2
    # and 4 tiles of 8 steps); ragged tiles (C = 5, 12, 20)
    (2, 512, 3, 16, 8, None), (2, 512, 3, 16, 16, None),
    (1, 512, 2, 16, 32, None), (2, 512, 2, 32, 8, None),
    (1, 512, 2, 32, 16, None), (1, 512, 2, 32, 32, None),
    (2, 40, 3, 64, 5, None), (2, 48, 2, 16, 12, None),
    (1, 60, 2, 64, 20, None),
]


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def draw(dev, B, S, H, K, seed, w_fixed=None, state=False):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, S, H, K)) for _ in range(3))
    w = np.clip(-np.exp(0.5 * rng.normal(size=(B, S, H, K))), -4.0, -1e-6)
    if w_fixed is not None:
        w = np.full_like(w, w_fixed)
    u = 0.5 * rng.normal(size=(H, K))
    s0 = rng.normal(size=(B, H, K, K)) if state else None
    return [None if a is None else
            torch.from_numpy(np.asarray(a, np.float32)).to(dev)
            for a in (r, k, v, w, u, s0)]


def close_to_max(got, want, tol, what):
    torch.testing.assert_close(got, want, rtol=tol,
                               atol=tol * float(want.abs().max()), msg=what)


@pytest.mark.parametrize("B,S,H,K,chunk,w_fixed", CASES)
def test_cuda_kernel_matches_plain(B, S, H, K, chunk, w_fixed):
    dev = card()
    r, k, v, w, u, _ = draw(dev, B, S, H, K, S + K, w_fixed)
    before = wkv6_kernel.launches
    y, s = wkv6_kernel(r, k, v, w, u, chunk=chunk)
    torch.cuda.synchronize()
    assert wkv6_kernel.launches == before + 1
    py, ps = wkv6_chunked(r, k, v, w, u, chunk=chunk)
    close_to_max(y, py, REL_TOL, "y vs plain")
    close_to_max(s, ps, REL_TOL, "state vs plain")
    oy, os_ = wkv6_scan_oracle(r, k, v, w, u)
    torch.testing.assert_close(y, oy, rtol=ORACLE_TOL, atol=ORACLE_TOL)
    torch.testing.assert_close(s, os_, rtol=ORACLE_TOL, atol=ORACLE_TOL)


def test_cuda_kernel_from_a_state_at_the_prefill_shape():
    """A non-zero state0 at the rwkv6-1.6b prefill shape, as a prefill
    continuing from the cache: y and the final state against the plain
    version and the scan oracle."""
    dev = card()
    r, k, v, w, u, s0 = draw(dev, 4, 2048, 32, 64, 11, state=True)
    y, s = wkv6_kernel(r, k, v, w, u, state0=s0)
    py, ps = wkv6_chunked(r, k, v, w, u, state0=s0, chunk=16)
    close_to_max(y, py, REL_TOL, "y vs plain")
    close_to_max(s, ps, REL_TOL, "state vs plain")
    oy, os_ = wkv6_scan_oracle(r, k, v, w, u, state0=s0)
    torch.testing.assert_close(y, oy, rtol=ORACLE_TOL, atol=ORACLE_TOL)
    torch.testing.assert_close(s, os_, rtol=ORACLE_TOL, atol=ORACLE_TOL)


def test_cuda_shared_memory_is_the_mirror():
    """The dynamic shared memory of every compiled instance
    (``repro_wkv6_smem``) is the wrapper's ``smem_bytes``, for every K and
    chunk; a pair the kernel does not take reads -1."""
    card()
    lib = W6K.LIBRARY.get()
    for K in W6K.HEAD_DIMS:
        for C in range(1, W6K.MAX_CHUNK + 1):
            assert lib.repro_wkv6_smem(K, C) == W6K.smem_bytes(K, C), (K, C)
    assert lib.repro_wkv6_smem(48, 16) == lib.repro_wkv6_smem(64, 33) == -1


def test_cuda_kernel_carries_the_state():
    """One call equals two halves, the second from the first's state; a
    non-zero state0 matches the plain version."""
    dev = card()
    r, k, v, w, u, s0 = draw(dev, 2, 128, 4, 64, 7, state=True)
    y_full, s_full = wkv6_kernel(r, k, v, w, u)
    h = 64
    y1, s1 = wkv6_kernel(r[:, :h].contiguous(), k[:, :h].contiguous(),
                         v[:, :h].contiguous(), w[:, :h].contiguous(), u)
    y2, s2 = wkv6_kernel(r[:, h:].contiguous(), k[:, h:].contiguous(),
                         v[:, h:].contiguous(), w[:, h:].contiguous(), u,
                         state0=s1)
    close_to_max(torch.cat([y1, y2], 1), y_full, REL_TOL, "carried y")
    close_to_max(s2, s_full, REL_TOL, "carried state")
    y, s = wkv6_kernel(r, k, v, w, u, state0=s0)
    py, ps = wkv6_chunked(r, k, v, w, u, state0=s0, chunk=16)
    close_to_max(y, py, REL_TOL, "state0 y vs plain")
    close_to_max(s, ps, REL_TOL, "state0 state vs plain")
