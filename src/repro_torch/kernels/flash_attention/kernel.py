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

Training: :class:`FlashAttention` is the autograd function of the
attention.  Its forward launches the same kernel and also keeps each row's
logsumexp (:func:`flash_attention_fwd`); its backward is
:func:`flash_attention_bwd`, ``csrc/flash_attention_bwd.cu``: a key-block
pass for dK and dV (a kv head's G query heads summed in the block) and a
query-block pass for dQ, no float atomics, so a step is deterministic.  It
replaces no TPU kernel (the reference differentiates its plain
``blockwise_attention``); its plain version is autograd through
:func:`repeat_kv_attention`, which the CPU runs.
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
    {"repro_flash_attention": [P] * 5 + [I] * 7 + [ctypes.c_float, P]})
BWD_LIBRARY = CudaLibrary(
    Path(__file__).resolve().parent / "csrc" / "flash_attention_bwd.cu",
    {"repro_flash_attention_bwd": [P] * 10 + [I] * 7 + [ctypes.c_float, P]})


def repeat_kv_attention(q, k, v, positions, window: int = 0):
    """Plain version: K/V repeated to H heads (head h reads kv head
    h // G), then the blockwise online-softmax scan."""
    G = q.shape[2] // k.shape[2]
    kf = k.repeat_interleave(G, dim=2)
    vf = v.repeat_interleave(G, dim=2)
    return blockwise_attention(q, kf, vf, positions, window=window)


def check_shapes(q, k, v, window: int, extra=(), aligned16=()):
    """Raise on anything the kernel (and the reference) does not take;
    the device is checked last.  ``extra``: more operands for
    :func:`check`, as (name, tensor, dtype, shape); ``aligned16``: (name,
    tensor) pairs that must start on 16 bytes."""
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
    for name, x in aligned16:
        if x.data_ptr() % 16:
            raise ValueError(f"flash_attention_bwd: {name} starts at an "
                             f"address that is not a multiple of 16 bytes")
    check(("q", q, q.dtype, (B, S, H, hd)),
          ("k", k, q.dtype, (B, S, Hkv, hd)),
          ("v", v, q.dtype, (B, S, Hkv, hd)), *extra)


def _forward(q, k, v, window: int, lse):
    """Launch the forward kernel (``lse``: None, or the (B, H, S) float32
    tensor it fills); counted on :func:`flash_attention`."""
    check_shapes(q, k, v, window)
    B, S, H, hd = q.shape
    out = torch.empty_like(q)
    LIBRARY.launch("repro_flash_attention", q, k, v, out, lse, B, S, H,
                   k.shape[2], hd, window, int(q.dtype == torch.bfloat16),
                   hd ** -0.5)
    flash_attention.launches += 1
    return out


def flash_attention(q, k, v, window: int = 0):
    """q: (B, S, H, hd); k, v: (B, S, Hkv, hd).  Causal over positions
    0..S-1; optional window.  Returns (B, S, H, hd) in q's dtype.  Where a
    gradient is wanted it goes through :class:`FlashAttention`."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, window)
    if q.device.type == "cpu":
        positions = torch.arange(q.shape[1], dtype=torch.int32)
        return repeat_kv_attention(q, k, v, positions, window)
    return _forward(q, k, v, window, None)


flash_attention.launches = 0


def attention_lse(q, k, window: int = 0):
    """Plain version of the forward's second output: each row's
    logsumexp of the scaled, masked float32 scores, (B, H, S)."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, H // Hkv, hd).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * hd ** -0.5
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(S, device=q.device)[None, :]
    mask = j <= i
    if window:
        mask &= j > i - window
    s = torch.where(mask, s, -1e30)
    return torch.logsumexp(s, dim=-1).reshape(B, H, S)


def flash_attention_fwd(q, k, v, window: int = 0):
    """The training forward: (out, lse), lse (B, H, S) float32.  The kernel
    on CUDA tensors; on CPU tensors the plain versions."""
    if q.device.type == "cpu":
        positions = torch.arange(q.shape[1], dtype=torch.int32)
        return (repeat_kv_attention(q, k, v, positions, window),
                attention_lse(q, k, window))
    B, S, H, _ = q.shape
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    return _forward(q, k, v, window, lse), lse


def attention_bwd_plain(q, k, v, dout, window: int = 0):
    """Plain version of the backward: autograd through
    :func:`repeat_kv_attention`.  Returns (dq, dk, dv)."""
    with torch.enable_grad():
        qq, kk, vv = (x.detach().requires_grad_(True) for x in (q, k, v))
        positions = torch.arange(q.shape[1], dtype=torch.int32,
                                 device=q.device)
        out = repeat_kv_attention(qq, kk, vv, positions, window)
        return torch.autograd.grad(out, (qq, kk, vv), dout)


def flash_attention_bwd(q, k, v, out, lse, dout, window: int = 0):
    """Gradients (dq, dk, dv) of :func:`flash_attention` at ``dout``, from
    the forward's ``out`` and ``lse``: the backward kernel on CUDA tensors
    (raises if the operands or the launch are wrong), its plain version on
    CPU tensors (which recomputes and ignores ``out`` and ``lse``)."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, dout, window)
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    # the kernel reads 4 elements a load, from 16-byte-aligned rows
    check_shapes(q, k, v, window,
                 extra=(("out", out, q.dtype, (B, S, H, hd)),
                        ("dout", dout, q.dtype, (B, S, H, hd)),
                        ("lse", lse, torch.float32, (B, H, S))),
                 aligned16=(("q", q), ("k", k), ("v", v), ("out", out),
                            ("dout", dout)))
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    BWD_LIBRARY.launch("repro_flash_attention_bwd", q, k, v, out, lse, dout,
                       dq, dk, dv, delta, B, S, H, Hkv, hd, window,
                       int(q.dtype == torch.bfloat16), hd ** -0.5)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: :func:`flash_attention_fwd`, whose
    output and logsumexp the backward :func:`flash_attention_bwd` reads."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        out, lse = flash_attention_fwd(q, k, v, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(), ctx.window)
        return dq, dk, dv, None
