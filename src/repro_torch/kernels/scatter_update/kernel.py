"""Binned segment scatter, the Dalorex T3 apply step in block form (port
of ``repro.kernels.scatter_update.kernel``).

:func:`scatter_segments` replaces the TPU kernel
``src/repro/kernels/scatter_update/kernel.py:47``: bin ``i`` folds its
``cap`` updates into its own ``(b,)`` block of the value array, ``idx ==
-1`` marking an empty slot.  On CPU tensors it runs its plain version
:func:`binned_scatter`; on CUDA tensors it launches
``csrc/scatter_segments.cu`` over a grid (NB, G) of column-owning blocks
(:func:`repro_torch.kernels.engine.kernel.column_split`: block ``(i,
j)`` owns a range of bin ``i``'s slots and applies only the updates that
land there; the add sorts, order-keeping, the updates of the slots that
get more than one, in row-order chunks of ``FOLD_ADD_MAX_ROWS`` updates a
bin where there are more: ``scatter_segments.path``; the min folds with
integer atomics, a NaN ranked by its place: :func:`~repro_torch.kernels.
engine.kernel.fold_order_key`) and raises if the launch failed.  Both add
each slot's updates in row order, so both are bitwise equal to the serial
:func:`repro_torch.kernels.scatter_update.ref.scatter_ref`; the TPU
kernel's one-hot matrix product sums in another order and agrees within
rounding.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels.cuda_build import I, P, CudaLibrary, check
from repro_torch.kernels.engine.kernel import (ORDERED_SCATTER, add_chunks,
                                               device_split, min_fold,
                                               min_fold_parts,
                                               ordered_scatter_add)

_INF = float(np.finfo(np.float32).max)
LIBRARY = CudaLibrary(
    Path(__file__).resolve().parent / "csrc" / "scatter_segments.cu",
    {"repro_scatter_segments_add": [P] * 4 + [I] * 5 + [P],
     "repro_scatter_segments_min": [P] * 4 + [I] * 5 + [P]},
    headers=(ORDERED_SCATTER,))


def binned_scatter(base, idx, vals, op: str):
    """Plain version: base (NB, b) f32, idx (NB, cap) int32 (-1 empty),
    vals (NB, cap) f32 -> (NB, b) f32.  The min is the engine's
    :func:`~repro_torch.kernels.engine.kernel.min_fold` (the empty slots
    folded into a trash column): the Pallas body's bits on NaN and signed
    zeros, -0.0 below +0.0."""
    if op == "add":
        return ordered_scatter_add(base, idx, vals)  # skips idx == -1
    NB, b = base.shape
    ext = torch.cat([base, base.new_full((NB, 1), _INF)], dim=1)
    out = min_fold(ext, torch.where(idx < 0, b, idx).to(torch.int64), vals)
    return out[:, :b].contiguous()


def scatter_segments(base, idx, vals, op: str = "min"):
    """base: (NB, b) f32; idx: (NB, cap) int32 local indices (-1 empty);
    vals: (NB, cap) f32.  Returns the updated (NB, b) f32 blocks."""
    if op not in ("min", "add"):
        raise ValueError(op)
    if base.device.type == "cpu":
        return binned_scatter(base, idx, vals, op)
    NB, b = base.shape
    cap = idx.shape[1]
    check(("base", base, torch.float32, (NB, b)),
          ("idx", idx, torch.int32, (NB, cap)),
          ("vals", vals, torch.float32, (NB, cap)))
    split = device_split(NB, b, base.device)
    out = base
    for part in ([(idx, vals)] if op == "add"
                 else min_fold_parts(idx, vals)):
        out, prev = torch.empty_like(base), out
        LIBRARY.launch(f"repro_scatter_segments_{op}", prev, *part, out, NB,
                       b, part[0].shape[1], *split)
        scatter_segments.launches += 1
    scatter_segments.path = add_chunks(cap) if op == "add" else None
    return out


scatter_segments.launches = 0
scatter_segments.path = None
