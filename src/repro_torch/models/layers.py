"""Shared LM building blocks (port of ``repro.models.layers``): RMSNorm,
RoPE, GQA attention and the MLP variants.

Every product accumulates in float32, as the reference's
``preferred_element_type=float32``: :func:`matmul_f32` returns the float32
result, which the caller casts.  For bfloat16 operands it multiplies
exactly (a product of two bfloat16 values fits a float32) and sums in
float32 — on the card through ``torch.mm(..., out_dtype=torch.float32)``,
whose float32 output leaves no room for the bfloat16 split-K reduction
that ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
permits for a bfloat16 output, and without touching that flag.  That
call has no derivative, so a product that needs a gradient goes through
:class:`_MatmulF32`, whose backward keeps the float32 cotangent, as the
reference's transpose of a ``preferred_element_type=float32`` product
does.  A float32 product follows the caller's TF32 setting (off by
default).

:func:`blockwise_attention` is the reference's two-level flash pattern
(online softmax over kv blocks), the plain version of the port's flash
kernel (:mod:`repro_torch.kernels.flash_attention`); it keeps
``NEG_INF = -1e30`` and the ``1e-30`` clamp on the softmax sum.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.parallel.sharding import ParamSpec

NEG_INF = -1e30


def split_bf16(x):
    """Float32 ``x`` as three bfloat16 terms whose float32 sum is ``x``:
    each takes the next 8 significand bits of what the terms before it
    left (24 in all; bfloat16 has float32's exponents), exactly wherever
    ``|x| >= 2**-108``, where the last term is still a normal number."""
    hi = x.to(torch.bfloat16)
    rest = x - hi  # float32: hi widens exactly
    mid = rest.to(torch.bfloat16)
    return hi, mid, (rest - mid).to(torch.bfloat16)


class _MatmulF32(torch.autograd.Function):
    """``a @ w`` of two bfloat16 CUDA operands with a float32 output,
    differentiable: ``torch.mm(..., out_dtype=torch.float32)`` has no
    derivative.  The backward's products take the float32 cotangent
    whole, as the reference's (``dot_general`` of the float32 cotangent
    and the bfloat16 operand): it is cut into :func:`split_bf16`'s three
    terms, each product of a term and an operand is exact in float32 and
    summed in float32, and only each gradient is rounded to bfloat16."""

    @staticmethod
    def forward(ctx, a2, w2):
        ctx.save_for_backward(a2, w2)
        return torch.mm(a2, w2, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, dy):
        a2, w2 = ctx.saved_tensors
        g = split_bf16(dy.float())
        da = dw = None
        if ctx.needs_input_grad[0]:
            da = _sum_of_products([(t, w2.t()) for t in g]).to(a2.dtype)
        if ctx.needs_input_grad[1]:
            dw = _sum_of_products([(a2.t(), t) for t in g]).to(w2.dtype)
        return da, dw


def _sum_of_products(pairs):
    """The float32 sum of ``x @ y`` (float32 outputs) over ``pairs``, in
    their order."""
    acc = torch.mm(*pairs[0], out_dtype=torch.float32)
    for x, y in pairs[1:]:
        acc += torch.mm(x, y, out_dtype=torch.float32)
    return acc


def matmul_f32(a, w):
    """``a`` (..., K) times ``w`` (K, ...) -> (..., *w.shape[1:]) float32,
    accumulated in float32 whatever the operands' dtype."""
    K = a.shape[-1]
    out_shape = a.shape[:-1] + w.shape[1:]
    a2, w2 = a.reshape(-1, K), w.reshape(K, -1)
    if a2.dtype == torch.float32 and w2.dtype == torch.float32:
        y = torch.mm(a2, w2)
    elif a2.device.type == "cuda" and a2.dtype == w2.dtype == torch.bfloat16:
        if torch.is_grad_enabled() and (a2.requires_grad
                                        or w2.requires_grad):
            y = _MatmulF32.apply(a2, w2)
        else:
            y = torch.mm(a2, w2, out_dtype=torch.float32)
    else:
        y = torch.mm(a2.float(), w2.float())
    return y.reshape(out_shape)


def rms_norm(x, scale, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def rope(x, positions, theta: float = 1e4):
    """x: (..., S, H, hd); positions: (..., S) or (S,).  Rotates the two
    halves of the head (not interleaved pairs)."""
    hd = x.shape[-1]
    half = hd // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(theta, exps)  # float32, as the reference's
    angles = positions[..., None].float() * freq  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Blockwise causal attention (train / prefill).
# --------------------------------------------------------------------------

def _attn_block(q, k, v, qpos, kpos, window):
    """One (q-block, kv-block) tile.  q: (B, qb, Hkv, G, hd);
    k/v: (B, kb, Hkv, hd).  Returns the masked float32 scores
    (B, Hkv, G, qb, kb)."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale
    mask = kpos[None, :] <= qpos[:, None]  # causal
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    return torch.where(mask[None, None, None], s, NEG_INF)


def blockwise_attention(q, k, v, positions, window: int = 0,
                        q_block: int = 512, kv_block: int = 512):
    """Causal (optionally windowed) attention, memory O(S·block).

    q: (B, S, H, hd); k, v: (B, S, Hkv, hd); positions: (S,).
    Outer loop over q blocks, inner over kv blocks (every one, as the
    reference's scan), carrying the online-softmax (m, l, acc) triple."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    q_block = min(q_block, S)
    kv_block = min(kv_block, S)
    if S % q_block or S % kv_block:
        raise ValueError(f"blockwise_attention: S={S} is not a multiple of "
                         f"the blocks ({q_block}, {kv_block})")
    nq, nk = S // q_block, S // kv_block
    qg = q.reshape(B, S, Hkv, G, hd).float()
    kf, vf = k.float(), v.float()
    outs = []
    for iq in range(nq):
        qs = slice(iq * q_block, (iq + 1) * q_block)
        qi, qpos = qg[:, qs], positions[qs]
        m = torch.full((B, Hkv, G, q_block), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, Hkv, G, q_block), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((B, Hkv, G, q_block, hd), dtype=torch.float32,
                          device=q.device)
        for ik in range(nk):
            ks = slice(ik * kv_block, (ik + 1) * kv_block)
            vi = vf[:, ks]
            s = _attn_block(qi, kf[:, ks], vi, qpos, positions[ks], window)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p, vi)
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        # (B, Hkv, G, qb, hd) -> (B, qb, H, hd)
        out = out.permute(0, 3, 1, 2, 4).reshape(B, q_block, H, hd)
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=1)


def decode_attention(q, k_cache, v_cache, cache_positions, q_position,
                     window: int = 0):
    """Single-token attention against a (ring-buffered) KV cache.

    q: (B, 1, H, hd); caches: (B, C, Hkv, hd); cache_positions: (B, C)
    sequence position held in each slot (-1 = empty); q_position: (B,)."""
    B, _, H, hd = q.shape
    Hkv = k_cache.shape[2]
    G = H // Hkv
    scale = hd ** -0.5
    qg = q.reshape(B, Hkv, G, hd).float()
    s = torch.einsum("bhgd,bchd->bhgc", qg, k_cache.float()) * scale
    mask = (cache_positions >= 0) & (cache_positions <= q_position[:, None])
    if window:
        mask &= cache_positions > q_position[:, None] - window
    s = torch.where(mask[:, None, None], s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1)
    out = torch.einsum("bhgc,bchd->bhgd", p, v_cache.float())
    out = out / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(B, 1, H, hd).to(q.dtype)


# --------------------------------------------------------------------------
# MLP variants.
# --------------------------------------------------------------------------

def mlp_apply(params, x, kind: str):
    """x: (..., d).  Weights are laid out (d, ff) / (ff, d)."""
    if kind == "swiglu":
        g = matmul_f32(x, params["w_gate"])
        u = matmul_f32(x, params["w_up"])
        h = (F.silu(g) * u).to(x.dtype)
    elif kind == "squared_relu":
        u = matmul_f32(x, params["w_up"])
        h = torch.square(torch.relu(u)).to(x.dtype)
    elif kind == "gelu":
        u = matmul_f32(x, params["w_up"])
        h = F.gelu(u, approximate="tanh").to(x.dtype)  # jax.nn.gelu's
    else:
        raise ValueError(kind)
    return matmul_f32(h, params["w_down"]).to(x.dtype)


def mlp_specs(d: int, ff: int, kind: str, dtype: str):
    if kind == "swiglu":
        return {
            "w_gate": ParamSpec((d, ff), ("fsdp", "mlp"), dtype),
            "w_up": ParamSpec((d, ff), ("fsdp", "mlp"), dtype),
            "w_down": ParamSpec((ff, d), ("mlp", "fsdp"), dtype),
        }
    return {
        "w_up": ParamSpec((d, ff), ("fsdp", "mlp"), dtype),
        "w_down": ParamSpec((ff, d), ("mlp", "fsdp"), dtype),
    }
