"""Block-ELL SpMV, the paper's SpMV workload in block form (port of
``repro.kernels.spmv.kernel``).

:func:`spmv_block_ell` replaces the TPU kernel
``src/repro/kernels/spmv/kernel.py:42``: ``y = A x`` with ``A`` stored as
``NB`` row-blocks of ``S`` dense ``(b, b)`` blocks, ``bcols == -1``
marking an empty slot.  On CPU tensors it runs its plain version
:func:`block_ell_matvec`; on CUDA tensors it launches
``csrc/spmv_block_ell.cu`` (one block of ``b`` threads per row-block, one
row's dot product per thread) and raises if the launch failed.  The
kernel, the plain version and the TPU kernel sum in different orders, so
they agree within rounding (``rtol = atol = 1e-4``, the reference's own).
"""
from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.kernels.cuda_build import I, P, CudaLibrary, check

# the kernel runs b threads per row-block and stages 32 columns at a time
MAX_BLOCK = 256
LIBRARY = CudaLibrary(
    Path(__file__).resolve().parent / "csrc" / "spmv_block_ell.cu",
    {"repro_spmv_block_ell": [P] * 4 + [I] * 3 + [P]})


def block_ell_matvec(bvals, bcols, x_pad):
    """Plain version: bvals (NB, S, b, b) f32, bcols (NB, S) int32 (-1 or
    any value outside [0, NB) is an empty slot), x_pad (NB*b,) f32 ->
    y (NB*b,) f32."""
    NB, S, b, _ = bvals.shape
    live = (bcols >= 0) & (bcols < NB)
    xb = x_pad.reshape(NB, b)[torch.where(live, bcols, 0).to(torch.int64)]
    prod = torch.matmul(bvals, xb[..., None])[..., 0]   # (NB, S, b)
    return torch.where(live[..., None], prod, 0.0).sum(dim=1).reshape(-1)


def spmv_block_ell(bvals, bcols, x_pad):
    """bvals: (NB, S, b, b) f32; bcols: (NB, S) int32 (-1 empty);
    x_pad: (NB*b,) f32.  Returns y (NB*b,) f32."""
    if bvals.device.type == "cpu":
        return block_ell_matvec(bvals, bcols, x_pad)
    NB, S, b, _ = bvals.shape
    check(("bvals", bvals, torch.float32, (NB, S, b, b)),
          ("bcols", bcols, torch.int32, (NB, S)),
          ("x_pad", x_pad, torch.float32, (NB * b,)))
    if b % 32 or not 32 <= b <= MAX_BLOCK:
        raise ValueError(f"spmv_block_ell: block {b} must be a multiple of "
                         f"32 in [32, {MAX_BLOCK}]")
    y = torch.empty(NB * b, dtype=torch.float32, device=bvals.device)
    LIBRARY.launch("repro_spmv_block_ell", bvals, bcols, x_pad, y, NB, S, b)
    spmv_block_ell.launches += 1
    return y


spmv_block_ell.launches = 0
