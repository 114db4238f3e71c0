"""Mamba2 (SSD) blocks for the zamba2 hybrid (port of
``repro.models.mamba``), with an O(1) decode state per layer: the last
CONV_K - 1 raw conv inputs and the (H, P, N) float32 SSD state.

The recurrence goes through :func:`repro_torch.kernels.mamba2.ops.ssd`:
the Hopper SSD kernel in prefill (``use_kernels=True`` on CUDA tensors),
its chunked plain version otherwise, and one plain step in decode.  The
projections accumulate in float32 (:func:`matmul_f32`) and the casts are
the reference's: the conv of ``cfg.dtype`` inputs with float32 weights is
float32, as JAX promotes it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba2 import ops as ssd_ops
from repro_torch.models.layers import matmul_f32, rms_norm
from repro_torch.parallel.sharding import ParamSpec

CONV_K = 4


def mamba_block_specs(d: int, expand: int, head_dim: int, N: int, dtype: str):
    din = expand * d
    H = din // head_dim
    proj_out = 2 * din + 2 * N + H  # z, x, B, C, dt
    return {
        "norm": ParamSpec((d,), (None,), "float32", init="ones"),
        "in_proj": ParamSpec((d, proj_out), ("fsdp", "heads"), dtype),
        "conv_w": ParamSpec((CONV_K, din + 2 * N), (None, None), "float32"),
        "conv_b": ParamSpec((din + 2 * N,), (None,), "float32", init="zeros"),
        "a_log": ParamSpec((H,), (None,), "float32", init="zeros"),
        "d_skip": ParamSpec((H,), (None,), "float32", init="ones"),
        "dt_bias": ParamSpec((H,), (None,), "float32", init="zeros"),
        "norm_g": ParamSpec((din,), (None,), "float32", init="ones"),
        "out_proj": ParamSpec((din, d), ("heads", "fsdp"), dtype),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv, kernel CONV_K.  x: (B, S, C)."""
    S = x.shape[1]
    pad = F.pad(x, (0, 0, CONV_K - 1, 0))
    out = sum(pad[:, i:i + S] * w[i][None, None] for i in range(CONV_K))
    return out + b[None, None]


def _conv_step(conv_state, xt, w, b):
    """conv_state: (B, CONV_K-1, C) previous inputs; xt: (B, C)."""
    full = torch.cat([conv_state, xt[:, None]], dim=1)  # (B, K, C)
    out = torch.einsum("bkc,kc->bc", full.float(), w) + b[None]
    return full[:, 1:], out


def _softplus(x):
    """log(1 + e^x) as ``jax.nn.softplus`` computes it (logaddexp(x, 0))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def mamba_block(p, x, state, cfg, use_kernels: bool):
    """x: (B, S, d).  state = (conv (B, K-1, C), ssd (B, H, P, N)) or None
    (zeros).  Returns (x, new state).

    A prompt (S > 1) restarts the conv from zero padding and keeps its
    last K - 1 raw inputs as the conv state, while the SSD continues from
    ``state``'s, as the reference (``src/repro/models/mamba.py:62-75``);
    S = 1 with a state is a decode step."""
    B, S, d = x.shape
    din = cfg.ssm_expand * d
    hp, N = cfg.ssm_head_dim, cfg.ssm_state
    H = din // hp
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    zxbcdt = matmul_f32(h, p["in_proj"]).to(x.dtype)
    z, xbc, dt = torch.split(zxbcdt, [din, din + 2 * N, H], dim=-1)

    if state is None or S > 1:
        if state is None:
            ssd_state = torch.zeros((B, H, hp, N), dtype=torch.float32,
                                    device=x.device)
        else:
            ssd_state = state[1]
        raw = xbc
        xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
        conv_state = torch.zeros((B, CONV_K - 1, din + 2 * N),
                                 dtype=x.dtype, device=x.device)
        take = min(S, CONV_K - 1)
        conv_state[:, CONV_K - 1 - take:] = raw[:, S - take:]
    else:
        conv_state, ssd_state = state
        conv_state, xbc1 = _conv_step(conv_state, xbc[:, 0], p["conv_w"],
                                      p["conv_b"])
        xbc = xbc1[:, None]
    xbc = F.silu(xbc)
    xs, Bm, Cm = torch.split(xbc, [din, N, N], dim=-1)
    dt = _softplus(dt.float() + p["dt_bias"][None, None])

    xh = xs.reshape(B, S, H, hp).float()
    y, ssd_state = ssd_ops.ssd(xh, dt, p["a_log"], Bm.float(), Cm.float(),
                               state0=ssd_state, use_kernel=use_kernels)
    y = y + xh * p["d_skip"][None, None, :, None]
    y = y.reshape(B, S, din)
    # gated RMSNorm (mamba2)
    y = rms_norm((y * F.silu(z.float())).to(x.dtype), p["norm_g"],
                 cfg.norm_eps)
    out = matmul_f32(y, p["out_proj"])
    return x + out.to(x.dtype), (conv_state, ssd_state)
