"""Attention entry point of the models (port of
``repro.kernels.flash_attention.ops``): the Hopper flash kernel or its
plain version."""
from __future__ import annotations

from repro_torch.kernels.flash_attention.kernel import (flash_attention,
                                                        repeat_kv_attention)


def attention(q, k, v, positions, window: int = 0, use_kernel: bool = True):
    """Causal attention of q (B, S, H, hd) over k, v (B, S, Hkv, hd).

    ``use_kernel=True`` calls :func:`flash_attention`, which launches the
    CUDA kernel on CUDA tensors (K/V not repeated; the positions are then
    0..S-1, as a prefill's are) and runs the plain version on CPU tensors.
    ``use_kernel=False`` runs the plain version on any device: K/V
    repeated to H heads, then the blockwise scan over ``positions``."""
    if use_kernel:
        if positions.shape != (q.shape[1],):
            raise ValueError(f"attention: positions must be (S,), got "
                             f"{tuple(positions.shape)}")
        return flash_attention(q, k, v, window=window)
    return repeat_kv_attention(q, k, v, positions, window)
