"""int8 error-feedback gradient compression (port of the part of
``repro.parallel.collectives`` that the trainer reaches, on one device).

quantize(g + residual) -> int8 -> dequantize; the quantization error rides
the residual into the next step, so the compressed optimizer converges to
the same fixed point.  ``axis=None`` only: on one device the collective
degenerates but the quantization arithmetic is the production path's.  A
data-parallel axis (the int8 psum over a mesh) is ROADMAP §1's "the rest
of the LM substrate".
"""
from __future__ import annotations

import torch

MESH_ITEM = "ROADMAP §1, still to port: the rest of the LM substrate"


def quantize_int8(g):
    """Per-tensor symmetric int8 quantization.  Returns (q, scale)."""
    amax = torch.max(torch.abs(g))
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def compressed_psum(g, residual, axis: str | None):
    """One error-feedback compressed SUM of one float32 tensor over
    ``axis`` (None: one device).  Returns (sum, new residual)."""
    if axis is not None:
        raise NotImplementedError(f"compressed_psum over axis {axis!r}: "
                                  f"{MESH_ITEM}")
    x = g + residual
    amax = torch.max(torch.abs(x))
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return deq, x - deq


def compress_tree(grads, residuals, axis: str | None):
    """compressed_psum leaf by leaf over nested dicts.  Returns (grads,
    residuals)."""
    if isinstance(grads, dict):
        out = {k: compress_tree(grads[k], residuals[k], axis)
               for k in sorted(grads)}
        return ({k: v[0] for k, v in out.items()},
                {k: v[1] for k, v in out.items()})
    return compressed_psum(grads, residuals, axis)
