"""RWKV6 "Finch" blocks: time mix (WKV with data-dependent decay) and
channel mix (port of ``repro.models.rwkv``).  Attention-free, with an
O(1) decode state per layer.

Weights follow the Finch structure: static token-shift lerps per
projection, a LoRA producing the per-channel data-dependent decay
``w_t``, and the per-channel bonus ``u``.  The recurrence goes through
:func:`repro_torch.kernels.rwkv6.ops.wkv6`: the Hopper WKV6 kernel in
prefill (``use_kernels=True`` on CUDA tensors), its chunked plain version
otherwise, and one plain step in decode.  Every projection accumulates in
float32 (:func:`matmul_f32`) and the casts are the reference's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.models.layers import matmul_f32, rms_norm
from repro_torch.parallel.sharding import ParamSpec

W_LORA_RANK = 32


def rwkv_block_specs(d: int, ff: int, head_dim: int, dtype: str):
    H = d // head_dim
    return {
        "ln1": ParamSpec((d,), (None,), "float32", init="ones"),
        "ln2": ParamSpec((d,), (None,), "float32", init="ones"),
        # time mix
        "mu": ParamSpec((5, d), (None, None), "float32", init="zeros"),
        "w_r": ParamSpec((d, d), ("fsdp", "heads"), dtype),
        "w_k": ParamSpec((d, d), ("fsdp", "heads"), dtype),
        "w_v": ParamSpec((d, d), ("fsdp", "heads"), dtype),
        "w_g": ParamSpec((d, d), ("fsdp", "heads"), dtype),
        "w_o": ParamSpec((d, d), ("heads", "fsdp"), dtype),
        "w0": ParamSpec((d,), (None,), "float32", init="zeros"),
        "w_lora_a": ParamSpec((d, W_LORA_RANK), (None, None), "float32"),
        "w_lora_b": ParamSpec((W_LORA_RANK, d), (None, None), "float32",
                              init="zeros"),
        "u": ParamSpec((H, head_dim), (None, None), "float32", init="zeros"),
        "ln_x": ParamSpec((d,), (None,), "float32", init="ones"),
        # channel mix
        "mu_c": ParamSpec((2, d), (None, None), "float32", init="zeros"),
        "w_ck": ParamSpec((d, ff), ("fsdp", "mlp"), dtype),
        "w_cv": ParamSpec((ff, d), ("mlp", "fsdp"), dtype),
        "w_cr": ParamSpec((d, d), ("fsdp", None), dtype),
    }


def _shift(x, last):
    """Token shift: x_{t-1} (last: (B, d) carry for the first position)."""
    return torch.cat([last[:, None], x[:, :-1]], dim=1)


def _time_mix(p, x, last_x, wkv_state, head_dim: int, use_kernels: bool):
    B, S, d = x.shape
    H = d // head_dim
    xs = _shift(x, last_x)
    mu = p["mu"].to(x.dtype)
    lerp = x[None] + (xs - x)[None] * mu[:, None, None]  # (5, B, S, d)
    lr, lk, lv, lw, lg = lerp
    r = matmul_f32(lr, p["w_r"])
    k = matmul_f32(lk, p["w_k"])
    v = matmul_f32(lv, p["w_v"])
    g = F.silu(matmul_f32(lg, p["w_g"]))
    # data-dependent decay (Finch): w = exp(-exp(w0 + tanh(lora(x))))
    lora = matmul_f32(matmul_f32(lw.float(), p["w_lora_a"]), p["w_lora_b"])
    w_log = -torch.exp(p["w0"][None, None] + torch.tanh(lora))
    # clipped so that the chunk's cumulated decays stay in float32's exp
    # range (chunk 16: exp(-L) <= e^64)
    w_log = torch.clamp(w_log, -4.0, -1e-6)

    shape4 = (B, S, H, head_dim)
    y, wkv_state = wkv_ops.wkv6(
        r.reshape(shape4), k.reshape(shape4), v.reshape(shape4),
        w_log.reshape(shape4), p["u"], state0=wkv_state,
        use_kernel=use_kernels)
    # per-head group norm
    yh = y.reshape(B, S, H, head_dim)
    yh = yh * torch.rsqrt(torch.mean(torch.square(yh), dim=-1, keepdim=True)
                          + 1e-5)
    y = yh.reshape(B, S, d) * p["ln_x"][None, None]
    out = matmul_f32((y * g).to(x.dtype), p["w_o"])
    return out.to(x.dtype), x[:, -1], wkv_state


def _channel_mix(p, x, last_x):
    xs = _shift(x, last_x)
    mu = p["mu_c"].to(x.dtype)
    lk = x + (xs - x) * mu[0][None, None]
    lr = x + (xs - x) * mu[1][None, None]
    kk = matmul_f32(lk, p["w_ck"])
    kk = torch.square(torch.relu(kk)).to(x.dtype)
    vv = matmul_f32(kk, p["w_cv"])
    rr = torch.sigmoid(matmul_f32(lr, p["w_cr"]))
    return (rr * vv).to(x.dtype), x[:, -1]


def rwkv_block(p, x, state, head_dim: int, eps: float, use_kernels: bool):
    """x: (B, S, d).  state = (last_tm (B, d), last_cm (B, d), wkv (B, H,
    K, K) float32) or None (zero state).  Returns (x, new state)."""
    B, S, d = x.shape
    H = d // head_dim
    if state is None:
        last_tm = torch.zeros((B, d), dtype=x.dtype, device=x.device)
        last_cm = torch.zeros((B, d), dtype=x.dtype, device=x.device)
        wkv = torch.zeros((B, H, head_dim, head_dim), dtype=torch.float32,
                          device=x.device)
    else:
        last_tm, last_cm, wkv = state
    h = rms_norm(x, p["ln1"], eps)
    att, last_tm, wkv = _time_mix(p, h, last_tm, wkv, head_dim, use_kernels)
    x = x + att
    h = rms_norm(x, p["ln2"], eps)
    cm, last_cm = _channel_mix(p, h, last_cm)
    x = x + cm
    return x, (last_tm, last_cm, wkv)
