"""Naive oracle: causal (windowed) attention with GQA, the whole score
matrix at once (port of ``repro.kernels.flash_attention.ref``)."""
from __future__ import annotations

import torch


def attention_ref(q, k, v, window: int = 0):
    """q: (B, S, H, hd); k, v: (B, S, Hkv, hd) -> (B, S, H, hd)."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, S, Hkv, G, hd).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * hd ** -0.5
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(S, device=q.device)[None, :]
    mask = j <= i
    if window:
        mask &= j > i - window
    s = torch.where(mask[None, None, None], s, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, S, H, hd).to(q.dtype)
