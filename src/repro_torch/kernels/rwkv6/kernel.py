"""Chunked RWKV6 WKV recurrence, the time mix of an rwkv6 prefill (port of
``repro.kernels.rwkv6.kernel``).

:func:`wkv6_kernel` replaces the TPU kernel ``wkv6_pallas``
(``src/repro/kernels/rwkv6/kernel.py:59``).  On CPU tensors it runs its
plain version :func:`repro_torch.kernels.rwkv6.ref.wkv6_chunked` at the
same chunk.  On CUDA tensors it launches ``csrc/wkv6.cu`` (a block a head
and batch row: chain warps carrying 16 value columns of the head's (K, K)
float32 state each, the chunk's products on the tensor cores in 3xTF32,
and prep warps forming the key side a chunk ahead) and raises if the
operands or the launch are wrong; there is no fallback.  The kernel and
the plain version sum in different orders: they agree within about 1e-5
of the largest magnitude of each output.
"""
from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.kernels.cuda_build import (I, MMA_TF32, P, CudaLibrary,
                                            aligned, check)
from repro_torch.kernels.rwkv6.ref import wkv6_chunked

HEAD_DIMS = (16, 32, 64)   # K, a template parameter of the kernel
MAX_CHUNK = 32             # exp(-L) overflows float32 above 22 steps of -4
LIBRARY = CudaLibrary(
    Path(__file__).resolve().parent / "csrc" / "wkv6.cu",
    {"repro_wkv6": [P] * 8 + [I] * 5 + [P], "repro_wkv6_smem": [I] * 2},
    headers=(MMA_TF32,))
# The most dynamic shared memory a block may opt in to on an H100
SMEM_LIMIT = 232_448


def smem_bytes(K: int, C: int) -> int:
    """The dynamic shared memory of the kernel's instance for head width
    ``K`` and chunk ``C``, in bytes: ``Layout<K, KT>::WORDS`` of
    ``csrc/wkv6.cu`` (the C function ``repro_wkv6_smem`` gives the
    compiled value), KT = 1, 2 or 4 tiles of 8 steps."""
    KT = 1 if C <= 8 else (2 if C <= 16 else 4)
    ra = 16 * ((KT + 1) // 2)          # rows of every tile
    tile = ra * (K + 8)                # (step, channel), stride K + 8
    stage = 4 * tile                   # r, k, v, w
    aset = 5 * tile + K + ra           # r_in, k_dec (hi, lo), k_neg,
                                       # exp(L_last), bonus
    bset = 2 * ra * (8 * KT + 4)       # att hi / lo
    return 4 * (3 * stage + 2 * aset + 2 * bset + K)


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
    # the kernel copies r, k, v and w_log in 16-byte pieces
    r, k, v, w_log = (aligned(a, 16) for a in (r, k, v, w_log))
    y = torch.empty_like(r)
    state = torch.empty((B, H, K, K), dtype=torch.float32, device=r.device)
    LIBRARY.launch("repro_wkv6", r, k, v, w_log, u,
                   0 if state0 is None else state0, y, state, B, S, H, K, C)
    wkv6_kernel.launches += 1
    return y, state


wkv6_kernel.launches = 0
