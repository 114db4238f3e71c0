"""Binned segment scatter, the Dalorex T3 apply step in block form (port
of ``repro.kernels.scatter_update.kernel``).

:func:`scatter_segments` replaces the TPU kernel
``src/repro/kernels/scatter_update/kernel.py:47``: bin ``i`` folds its
``cap`` updates into its own ``(b,)`` block of the value array, ``idx ==
-1`` marking an empty slot.  On CPU tensors it runs its plain version
:func:`binned_scatter`; on CUDA tensors it launches
``csrc/scatter_segments.cu`` (one block per bin: an order-keeping sort for
the add, float atomics for the min) and raises if the launch failed.  Both
add each slot's updates in row order, so both are bitwise equal to the
serial :func:`repro_torch.kernels.scatter_update.ref.scatter_ref`; the
TPU kernel's one-hot matrix product sums in another order and agrees
within rounding.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels.cuda_build import I, P, CudaLibrary, check
from repro_torch.kernels.engine.kernel import (FOLD_ADD_MAX_ROWS,
                                               ORDERED_SCATTER,
                                               ordered_scatter_add)

_INF = float(np.finfo(np.float32).max)
LIBRARY = CudaLibrary(
    Path(__file__).resolve().parent / "csrc" / "scatter_segments.cu",
    {"repro_scatter_segments_add": [P] * 4 + [I] * 3 + [P],
     "repro_scatter_segments_min": [P] * 4 + [I] * 3 + [P]},
    headers=(ORDERED_SCATTER,))


def binned_scatter(base, idx, vals, op: str):
    """Plain version: base (NB, b) f32, idx (NB, cap) int32 (-1 empty),
    vals (NB, cap) f32 -> (NB, b) f32."""
    if op == "add":
        return ordered_scatter_add(base, idx, vals)  # skips idx == -1
    NB, b = base.shape
    ext = torch.cat([base, base.new_full((NB, 1), _INF)], dim=1)
    ext.scatter_reduce_(1, torch.where(idx < 0, b, idx).to(torch.int64),
                        vals, "amin")
    return ext[:, :b].contiguous()


def scatter_segments(base, idx, vals, op: str = "min"):
    """base: (NB, b) f32; idx: (NB, cap) int32 local indices (-1 empty);
    vals: (NB, cap) f32.  Returns the updated (NB, b) f32 blocks."""
    if op not in ("min", "add"):
        raise ValueError(op)
    if base.device.type == "cpu":
        return binned_scatter(base, idx, vals, op)
    NB, b = base.shape
    cap = idx.shape[1]
    if op == "add" and cap > FOLD_ADD_MAX_ROWS:
        raise ValueError(f"scatter_segments(op='add') sorts at most "
                         f"{FOLD_ADD_MAX_ROWS} updates per bin in shared "
                         f"memory; got {cap}")
    check(("base", base, torch.float32, (NB, b)),
          ("idx", idx, torch.int32, (NB, cap)),
          ("vals", vals, torch.float32, (NB, cap)))
    out = torch.empty_like(base)
    LIBRARY.launch(f"repro_scatter_segments_{op}", base, idx, vals, out, NB,
                   b, cap)
    scatter_segments.launches += 1
    return out


scatter_segments.launches = 0
