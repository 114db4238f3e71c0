"""Causal flash attention, forward, with an optional sliding window and
grouped-query heads (port of ``repro.kernels.flash_attention.kernel``).

:func:`flash_attention` replaces the TPU kernel
``src/repro/kernels/flash_attention/kernel.py:72``.  On CPU tensors it
runs its plain version :func:`repeat_kv_attention`: K/V repeated to the
query heads, then :func:`repro_torch.models.layers.blockwise_attention`,
exactly what the reference's prefill runs.  On CUDA tensors it launches
``csrc/flash_attention.cu`` and raises if the operands or the launch are
wrong; there is no fallback.  bfloat16 runs on the tensor cores (a block
per 128-row query tile, head and batch: K/V tiles by TMA through a 2-stage
mbarrier ring, wgmma for QK^T and PV, P split into bfloat16 hi and lo
halves); float32 on CUDA-core FMAs (a block per 64-row tile).  Both read
query head h's kv head h // G in place and visit only the causal and
windowed kv tiles, with a float32 online softmax.  The kernel and the
plain version sum in different orders: they agree within 2e-5 in float32
and 2e-2 in bfloat16, the reference's tolerances
(``tests/test_kernels.py:37``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.cuda_build import I, P, CudaLibrary, check
from repro_torch.models.layers import blockwise_attention

# the head widths of the reference's sweep, and zamba2-2.7b's (2560 / 32)
HEAD_DIMS = (32, 64, 80, 128)
LIBRARY = CudaLibrary(
    Path(__file__).resolve().parent / "csrc" / "flash_attention.cu",
    {"repro_flash_attention": [P] * 4 + [I] * 7 + [ctypes.c_float, P]})


def repeat_kv_attention(q, k, v, positions, window: int = 0):
    """Plain version: K/V repeated to H heads (head h reads kv head
    h // G), then the blockwise online-softmax scan."""
    G = q.shape[2] // k.shape[2]
    kf = k.repeat_interleave(G, dim=2)
    vf = v.repeat_interleave(G, dim=2)
    return blockwise_attention(q, kf, vf, positions, window=window)


def check_shapes(q, k, v, window: int):
    """Raise on anything the kernel (and the reference) does not take;
    the device is checked last."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention: q and k must be 4-D, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention: q must be float32 or bfloat16, "
                        f"got {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in "
                         f"{HEAD_DIMS}")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"flash_attention: {H} query heads are not a "
                         f"multiple of {Hkv} kv heads")
    if S % min(512, S):
        raise ValueError(f"flash_attention: S={S} is not a multiple of "
                         f"min(512, S), the reference prefill's block "
                         f"(blockwise_attention)")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    for name, x in (("q", q), ("k", k), ("v", v)):
        # the bfloat16 body reads by TMA, from 16-byte-aligned addresses
        if q.dtype == torch.bfloat16 and x.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} starts at an address "
                             f"that is not a multiple of 16 bytes")
    check(("q", q, q.dtype, (B, S, H, hd)),
          ("k", k, q.dtype, (B, S, Hkv, hd)),
          ("v", v, q.dtype, (B, S, Hkv, hd)))


def flash_attention(q, k, v, window: int = 0):
    """q: (B, S, H, hd); k, v: (B, S, Hkv, hd).  Causal over positions
    0..S-1; optional window.  Returns (B, S, H, hd) in q's dtype."""
    if q.device.type == "cpu":
        positions = torch.arange(q.shape[1], dtype=torch.int32)
        return repeat_kv_attention(q, k, v, positions, window)
    check_shapes(q, k, v, window)
    B, S, H, hd = q.shape
    out = torch.empty_like(q)
    LIBRARY.launch("repro_flash_attention", q, k, v, out, B, S, H,
                   k.shape[2], hd, window, int(q.dtype == torch.bfloat16),
                   hd ** -0.5)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
