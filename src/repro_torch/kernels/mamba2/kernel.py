"""Chunked Mamba2 SSD recurrence, the selective-state scan of a zamba2
prefill (port of ``repro.kernels.mamba2.kernel``).

:func:`ssd_kernel` replaces the TPU kernel ``ssd_pallas``
(``src/repro/kernels/mamba2/kernel.py:55``).  On CPU tensors it runs its
plain version :func:`repro_torch.kernels.mamba2.ref.ssd_chunked` at the
same chunk.  On CUDA tensors it launches ``csrc/ssd.cu`` (a warp a head's
16 state rows, a block of 12 warps some heads of one batch row, the
chunk's products on the tensor cores in 3xTF32) and raises if the operands
or the launch are wrong; there is no fallback.  The kernel and the plain version
sum in different orders: they agree within about 1e-5 of the largest
magnitude of each output.
"""
from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.kernels.cuda_build import I, CudaLibrary, check
from repro_torch.kernels.cuda_build import P as PTR
from repro_torch.kernels.mamba2.ref import ssd_chunked

# P and N, template parameters of the kernel: the reference's sweep
# (tests/test_kernels.py:180-182), zamba2's reduced (32, 16) and full
# (64, 64) widths
HEAD_DIMS = (16, 32, 64)
STATE_DIMS = (8, 16, 64)
MAX_CHUNK = 32                 # the kernel's tiles hold 32 steps
LIBRARY = CudaLibrary(
    Path(__file__).resolve().parent / "csrc" / "ssd.cu",
    {"repro_ssd": [PTR] * 8 + [I] * 6 + [PTR]})


def check_operands(x, dt, a_log, Bm, Cm, state0, chunk: int):
    """Raise on anything the kernel does not take; the device is checked
    last.  Returns the chunk the kernel runs, min(chunk, S)."""
    if x.dim() != 4 or Bm.dim() != 3:
        raise ValueError(f"ssd: x must be (B, S, H, P) and B (B, S, N), "
                         f"got {tuple(x.shape)}, {tuple(Bm.shape)}")
    B, S, H, hp = x.shape
    N = Bm.shape[-1]
    if hp not in HEAD_DIMS:
        raise ValueError(f"ssd: head width P={hp} not in {HEAD_DIMS}")
    if N not in STATE_DIMS:
        raise ValueError(f"ssd: state width N={N} not in {STATE_DIMS}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"ssd: chunk {chunk} not in [1, {MAX_CHUNK}]")
    C = min(chunk, S)
    if S % C:
        raise ValueError(f"ssd: S={S} is not a multiple of the chunk "
                         f"min({chunk}, S) = {C}")
    f32 = torch.float32
    ops = [("x", x, f32, (B, S, H, hp)), ("dt", dt, f32, (B, S, H)),
           ("a_log", a_log, f32, (H,)), ("B", Bm, f32, (B, S, N)),
           ("C", Cm, f32, (B, S, N))]
    if state0 is not None:
        ops.append(("state0", state0, f32, (B, H, hp, N)))
    check(*ops)
    return C


def _aligned(t, nbytes: int):
    """``t``, or a copy of it that starts on ``nbytes`` bytes."""
    return t if t.data_ptr() % nbytes == 0 else t.clone()


def ssd_kernel(x, dt, a_log, Bm, Cm, state0=None, chunk: int = 16):
    """x: (B, S, H, P); dt: (B, S, H); a_log: (H,); Bm, Cm: (B, S, N);
    state0: (B, H, P, N) or None (zeros); all float32.  Returns (y (B, S,
    H, P), final state (B, H, P, N)), both float32."""
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, a_log, Bm, Cm, state0=state0, chunk=chunk)
    C = check_operands(x, dt, a_log, Bm, Cm, state0, chunk)
    B, S, H, hp = x.shape
    N = Bm.shape[-1]
    # the kernel copies x, B and C in 16-byte pieces, state0 in 8
    x, Bm, Cm = (_aligned(a, 16) for a in (x, Bm, Cm))
    if state0 is not None:
        state0 = _aligned(state0, 8)
    y = torch.empty_like(x)
    state = torch.empty((B, H, hp, N), dtype=torch.float32, device=x.device)
    LIBRARY.launch("repro_ssd", x, dt, a_log, Bm, Cm,
                   0 if state0 is None else state0, y, state, B, S, H, hp, N,
                   C)
    ssd_kernel.launches += 1
    return y, state


ssd_kernel.launches = 0
