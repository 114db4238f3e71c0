"""Block-ELL SpMV, the paper's SpMV workload in block form (port of
``repro.kernels.spmv.kernel``).

:func:`spmv_block_ell` replaces the TPU kernel
``src/repro/kernels/spmv/kernel.py:42``: ``y = A x`` with ``A`` stored as
``NB`` row-blocks of ``S`` dense ``(b, b)`` blocks, ``bcols == -1``
marking an empty slot.  On CPU tensors it runs its plain version
:func:`block_ell_matvec`; on CUDA tensors it launches
``csrc/spmv_block_ell.cu`` and raises if the launch failed.  The kernel
splits each row-block's slots over ``G`` blocks (:func:`groups`), reads
whole block rows as float4, and lets the last block of a row-block sum the
``G`` partials in group order, in the same launch: its result is the same
bit for bit from run to run.  The kernel, the plain version and the TPU
kernel sum in different orders, so they agree within rounding (``rtol =
atol = 1e-4``, the reference's own).
"""
from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.kernels.cuda_build import I, P, CudaLibrary, check

# the kernel has an instance for every multiple of 32 up to 256
MAX_BLOCK = 256
# blocks the grid keeps on every SM, at least (the wrapper's split)
BLOCKS_PER_SM = 8
LIBRARY = CudaLibrary(
    Path(__file__).resolve().parent / "csrc" / "spmv_block_ell.cu",
    {"repro_spmv_block_ell": [P] * 6 + [I] * 4 + [P]})


def block_ell_matvec(bvals, bcols, x_pad):
    """Plain version: bvals (NB, S, b, b) f32, bcols (NB, S) int32 (-1 or
    any value outside [0, NB) is an empty slot), x_pad (NB*b,) f32 ->
    y (NB*b,) f32."""
    NB, S, b, _ = bvals.shape
    live = (bcols >= 0) & (bcols < NB)
    xb = x_pad.reshape(NB, b)[torch.where(live, bcols, 0).to(torch.int64)]
    prod = torch.matmul(bvals, xb[..., None])[..., 0]   # (NB, S, b)
    return torch.where(live[..., None], prod, 0.0).sum(dim=1).reshape(-1)


def groups(NB: int, S: int, sms: int) -> int:
    """Slot groups a row-block is split over: enough for BLOCKS_PER_SM
    blocks on each of ``sms`` SMs, at most one slot a group."""
    return max(1, min(S, -(-BLOCKS_PER_SM * sms // max(NB, 1))))


def aligned16(x):
    """``x``, or a fresh copy of it if its address is not a multiple of 16
    bytes (the kernel reads float4s)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def spmv_block_ell(bvals, bcols, x_pad):
    """bvals: (NB, S, b, b) f32; bcols: (NB, S) int32 (-1 empty);
    x_pad: (NB*b,) f32.  Returns y (NB*b,) f32."""
    if bvals.device.type == "cpu":
        return block_ell_matvec(bvals, bcols, x_pad)
    NB, S, b, _ = bvals.shape
    if b % 32 or not 32 <= b <= MAX_BLOCK:
        raise ValueError(f"spmv_block_ell: block {b} must be a multiple of "
                         f"32 in [32, {MAX_BLOCK}]")
    check(("bvals", bvals, torch.float32, (NB, S, b, b)),
          ("bcols", bcols, torch.int32, (NB, S)),
          ("x_pad", x_pad, torch.float32, (NB * b,)))
    dev = bvals.device
    G = groups(NB, S, torch.cuda.get_device_properties(dev)
               .multi_processor_count)
    y = torch.empty(NB * b, dtype=torch.float32, device=dev)
    part = torch.empty(NB * G * b, dtype=torch.float32, device=dev)
    count = torch.zeros(NB, dtype=torch.int32, device=dev)
    LIBRARY.launch("repro_spmv_block_ell", aligned16(bvals), bcols,
                   aligned16(x_pad), y, part, count, NB, S, b, G)
    spmv_block_ell.launches += 1
    return y


spmv_block_ell.launches = 0
