"""Chunked RWKV6 WKV recurrence, the time mix of an rwkv6 prefill (port of
``repro.kernels.rwkv6.kernel``).

:func:`wkv6_kernel` replaces the TPU kernel ``wkv6_pallas``
(``src/repro/kernels/rwkv6/kernel.py:59``).  On CPU tensors it runs its
plain version :func:`repro_torch.kernels.rwkv6.ref.wkv6_chunked` at the
same chunk.  On CUDA tensors it launches ``csrc/wkv6.cu`` (one block per
head and batch row, carrying the head's (K, K) float32 state through the
chunks) and raises if the operands or the launch are wrong; there is no
fallback.  The kernel and the plain version sum in different orders: they
agree within about 1e-5 of the largest magnitude of each output.
"""
from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.kernels.cuda_build import I, P, CudaLibrary, check
from repro_torch.kernels.rwkv6.ref import wkv6_chunked

HEAD_DIMS = (16, 32, 64)   # K, a template parameter of the kernel
MAX_CHUNK = 32             # exp(-L) overflows float32 above 22 steps of -4
LIBRARY = CudaLibrary(
    Path(__file__).resolve().parent / "csrc" / "wkv6.cu",
    {"repro_wkv6": [P] * 8 + [I] * 5 + [P]})


def check_operands(r, k, v, w_log, u, state0, chunk: int):
    """Raise on anything the kernel does not take; the device is checked
    last.  Returns the chunk the kernel runs, min(chunk, S)."""
    if r.dim() != 4:
        raise ValueError(f"wkv6: r must be (B, S, H, K), got "
                         f"{tuple(r.shape)}")
    B, S, H, K = r.shape
    if K not in HEAD_DIMS:
        raise ValueError(f"wkv6: head width K={K} not in {HEAD_DIMS}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"wkv6: chunk {chunk} not in [1, {MAX_CHUNK}]")
    C = min(chunk, S)
    if S % C:
        raise ValueError(f"wkv6: S={S} is not a multiple of the chunk "
                         f"min({chunk}, S) = {C}")
    f32, seq = torch.float32, (B, S, H, K)
    ops = [("r", r, f32, seq), ("k", k, f32, seq), ("v", v, f32, seq),
           ("w_log", w_log, f32, seq), ("u", u, f32, (H, K))]
    if state0 is not None:
        ops.append(("state0", state0, f32, (B, H, K, K)))
    check(*ops)
    return C


def wkv6_kernel(r, k, v, w_log, u, state0=None, chunk: int = 16):
    """r, k, v, w_log: (B, S, H, K) float32; u: (H, K); state0: (B, H, K,
    K) or None (zeros).  Returns (y (B, S, H, K), final state (B, H, K,
    K)), both float32."""
    if r.device.type == "cpu":
        return wkv6_chunked(r, k, v, w_log, u, state0=state0, chunk=chunk)
    C = check_operands(r, k, v, w_log, u, state0, chunk)
    B, S, H, K = r.shape
    y = torch.empty_like(r)
    state = torch.empty((B, H, K, K), dtype=torch.float32, device=r.device)
    LIBRARY.launch("repro_wkv6", r, k, v, w_log, u,
                   0 if state0 is None else state0, y, state, B, S, H, K, C)
    wkv6_kernel.launches += 1
    return y, state


wkv6_kernel.launches = 0
