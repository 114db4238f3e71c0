"""The LMs: specs, params, decode cache, blocks and the serving
entry points (port of ``repro.models.transformer``, the dense, ssm and
hybrid families).

dense  — a pre-norm GQA transformer, granite-3-2b's family.
ssm    — an RWKV6 stack (attention-free), rwkv6-1.6b's family
         (:mod:`repro_torch.models.rwkv`).
hybrid — zamba2: superblocks of [shared attention + k Mamba2 layers]
         (:mod:`repro_torch.models.mamba`); the attention block's weights
         are shared across superblocks, each application has its own KV
         cache slot.

Parameters are nested dicts of tensors in the reference's layouts, the
block leaves stacked on a leading layer axis; the layer stack is a Python
loop.  Dense serving keeps a ring-buffered KV cache (slot = position mod
C); ssm serving keeps each layer's recurrent state (the two token-shift
carries and the WKV state), which a prefill continues from, as the
reference's does; hybrid serving keeps a ring KV cache per superblock and
each Mamba2 layer's conv and SSD state.  The ssm prefill's time mix goes
through the Hopper WKV6 kernel (``use_kernels=True``) or its chunked
plain version, the hybrid prefill's SSD scan through the Hopper SSD
kernel or its chunked plain version.  The prefill's attention (dense and
hybrid) goes through
:func:`repro_torch.kernels.flash_attention.attention`: the Hopper flash
kernel on the card (``use_kernels=True``), where the
reference calls ``blockwise_attention`` over K/V repeated to H heads
(``src/repro/models/transformer.py:270-275``), whose counterpart is the
kernel's plain version.  Decode attends with :func:`decode_attention`
(no kernel), as the reference does.

The cache tensors are written in place (they are the largest state of a
serving run); ``prefill``, ``serve_step`` and ``forward`` return a new
:class:`Cache` whose position has advanced, over the same tensors.

Training: :func:`lm_loss` is the causal LM loss of the dense family
through :func:`chunked_xent`, the logits taken a sequence chunk at a time.
Its forward runs the same attention entry point, whose flash kernel has a
hand-written backward (:class:`repro_torch.kernels.flash_attention.
kernel.FlashAttention`); ``remat=True`` recomputes each layer in the
backward (``torch.utils.checkpoint``), as the reference's
``jax.checkpoint`` of its scanned layer body.

Not ported: the MoE family, the vision and audio frontends, ring
(context-parallel) attention, which needs a mesh, and the training of the
ssm and hybrid families, which needs backward kernels of WKV6 and SSD;
each raises ``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.embedding import embed_lookup, padded_vocab
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.models.layers import (decode_attention, matmul_f32,
                                       mlp_apply, mlp_specs, rms_norm, rope)
from repro_torch.models.mamba import CONV_K, mamba_block, mamba_block_specs
from repro_torch.models.rwkv import rwkv_block, rwkv_block_specs
from repro_torch.optim.adamw import OptState
from repro_torch.parallel.sharding import ParamSpec, init_tree, tree_map

# the ROADMAP items that bring what is not ported
SUBSTRATE_ITEM = "ROADMAP §1, still to port: the rest of the LM substrate"
PORTED_FAMILIES = ("dense", "ssm", "hybrid")
# the families whose training is ported (the others' kernels have no
# backward yet)
TRAINED_FAMILIES = ("dense",)
TRAINING_ITEM = ("ROADMAP §1, still to port: rwkv6 and zamba2 training "
                 "(the WKV6 and SSD backward kernels)")


def check_trainable(cfg: ModelConfig):
    """Raise unless the port trains ``cfg``'s family."""
    _check_ported(cfg)
    if cfg.family not in TRAINED_FAMILIES:
        raise NotImplementedError(f"training family {cfg.family!r}: "
                                  f"{TRAINING_ITEM}")


def _check_ported(cfg: ModelConfig):
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r}: "
                                  f"{SUBSTRATE_ITEM}")
    if cfg.frontend != "none":
        raise NotImplementedError(f"frontend {cfg.frontend!r}: "
                                  f"{SUBSTRATE_ITEM}")


# --------------------------------------------------------------------------
# Parameter specs.
# --------------------------------------------------------------------------

def _attn_specs(cfg: ModelConfig):
    d, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    return {
        "ln": ParamSpec((d,), (None,), "float32", init="ones"),
        "wq": ParamSpec((d, H, hd), ("fsdp", "heads", None), cfg.dtype),
        "wk": ParamSpec((d, Hkv, hd), ("fsdp", "kv_heads", None), cfg.dtype),
        "wv": ParamSpec((d, Hkv, hd), ("fsdp", "kv_heads", None), cfg.dtype),
        "wo": ParamSpec((H, hd, d), ("heads", None, "fsdp"), cfg.dtype),
    }


def _dense_block_specs(cfg: ModelConfig):
    return {"attn": _attn_specs(cfg),
            "ln2": ParamSpec((cfg.d_model,), (None,), "float32",
                             init="ones"),
            "mlp": mlp_specs(cfg.d_model, cfg.d_ff, cfg.mlp, cfg.dtype)}


def _stack(specs, n: int):
    """Add a leading layer axis to every leaf spec."""
    return tree_map(lambda s: ParamSpec((n,) + s.shape, (None,) + s.axes,
                                        s.dtype, s.init, s.scale),
                    specs, is_leaf=lambda x: isinstance(x, ParamSpec))


def abstract_params(cfg: ModelConfig):
    """ParamSpec tree for the whole model.  One device, so the vocab is
    padded for one shard (the reference's model-axis size without a
    mesh)."""
    _check_ported(cfg)
    d, L = cfg.d_model, cfg.num_layers
    v_pad = padded_vocab(cfg.vocab_size, 1)
    vocab_axis = "vocab" if cfg.routed_embedding else None
    p = {
        "embed": ParamSpec((v_pad, d), (vocab_axis, None), cfg.dtype,
                           init="embed", scale=0.02),
        "final_norm": ParamSpec((d,), (None,), "float32", init="ones"),
        "lm_head": ParamSpec((d, v_pad), ("fsdp", "vocab"), cfg.dtype),
    }
    if cfg.family == "ssm":
        p["blocks"] = _stack(
            rwkv_block_specs(d, cfg.d_ff, cfg.rwkv_head_dim, cfg.dtype), L)
    elif cfg.family == "hybrid":
        k = cfg.attn_every
        if L % k:
            raise ValueError(f"hybrid: {L} layers are not a multiple of "
                             f"attn_every = {k}")
        p["shared_attn"] = {
            **_attn_specs(cfg),
            "ln2": ParamSpec((d,), (None,), "float32", init="ones"),
            "mlp": mlp_specs(d, cfg.d_ff, cfg.mlp, cfg.dtype),
        }
        p["blocks"] = _stack(_stack(
            mamba_block_specs(d, cfg.ssm_expand, cfg.ssm_head_dim,
                              cfg.ssm_state, cfg.dtype), k), L // k)
    else:
        p["blocks"] = _stack(_dense_block_specs(cfg), L)
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig, device="cuda"):
    """Random weights by the reference's init rule, drawn from ``gen`` (a
    generator on ``device``)."""
    return init_tree(gen, abstract_params(cfg), device)


# --------------------------------------------------------------------------
# Decode cache.
# --------------------------------------------------------------------------

class Cache(NamedTuple):
    pos: torch.Tensor              # () int32 — tokens decoded so far
    attn_k: torch.Tensor | None    # (n_attn, B, C, Hkv, hd)
    attn_v: torch.Tensor | None
    rwkv: tuple | None             # (last_tm, last_cm, wkv) leading (L, B)
    mamba: tuple | None            # (conv, ssd) leading (L // k, k, B)


def cache_slots(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.sliding_window:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def abstract_cache(cfg: ModelConfig, batch: int, seq_len: int):
    """ParamSpec tree for the decode cache."""
    _check_ported(cfg)
    L = cfg.num_layers
    pos = ParamSpec((), (), "int32", init="zeros")
    if cfg.family == "ssm":
        d, K = cfg.d_model, cfg.rwkv_head_dim
        carry = ParamSpec((L, batch, d), (None, "batch", None), cfg.dtype,
                          init="zeros")
        wkv = ParamSpec((L, batch, d // K, K, K),
                        (None, "batch", "heads", None, None), "float32",
                        init="zeros")
        return Cache(pos, None, None, (carry, carry, wkv), None)
    C = cache_slots(cfg, seq_len)
    n_attn, mamba = L, None
    if cfg.family == "hybrid":
        k = cfg.attn_every
        n_attn = L // k
        din = cfg.ssm_expand * cfg.d_model
        H = din // cfg.ssm_head_dim
        mamba = (
            ParamSpec((n_attn, k, batch, CONV_K - 1, din + 2 * cfg.ssm_state),
                      (None, None, "batch", None, None), cfg.dtype,
                      init="zeros"),
            ParamSpec((n_attn, k, batch, H, cfg.ssm_head_dim, cfg.ssm_state),
                      (None, None, "batch", "heads", None, None), "float32",
                      init="zeros"))
    shape = (n_attn, batch, C, cfg.num_kv_heads, cfg.hd)
    kv_axes = (None, "batch", "kv_seq", None, None)
    return Cache(pos, ParamSpec(shape, kv_axes, cfg.dtype, init="zeros"),
                 ParamSpec(shape, kv_axes, cfg.dtype, init="zeros"),
                 None, mamba)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device="cuda"):
    return init_tree(None, abstract_cache(cfg, batch, seq_len), device)


def _slot_positions(pos, C: int):
    """Sequence position stored in each ring slot (-1 = empty)."""
    i = torch.arange(C, dtype=torch.int32, device=pos.device)
    cand = pos - 1 - ((pos - 1 - i) % C)
    return torch.where(cand >= 0, cand, -1)


# --------------------------------------------------------------------------
# Attention and dense blocks.
# --------------------------------------------------------------------------

def _attn_apply(p, x, cfg: ModelConfig, kv_cache, pos, use_kernels: bool):
    """x: (B, S, d).  kv_cache: None (no cache) or (k, v) ring buffers
    (B, C, Hkv, hd), written in place.  Returns out (B, S, d)."""
    B, S, d = x.shape
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q = matmul_f32(h, p["wq"]).to(x.dtype)
    kk = matmul_f32(h, p["wk"]).to(x.dtype)
    vv = matmul_f32(h, p["wv"]).to(x.dtype)

    if kv_cache is None or S > 1:  # train / prefill
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
        q = rope(q, positions, cfg.rope_theta)
        kk = rope(kk, positions, cfg.rope_theta)
        att = attention(q, kk, vv, positions, window=cfg.sliding_window,
                        use_kernel=use_kernels)
        if kv_cache is not None:  # prefill into the ring cache
            ck, cv = kv_cache
            C = ck.shape[1]
            take = min(S, C)
            slots = (torch.arange(take, device=x.device) + (S - take)) % C
            ck.index_copy_(1, slots, kk[:, S - take:].to(ck.dtype))
            cv.index_copy_(1, slots, vv[:, S - take:].to(cv.dtype))
    else:  # decode: one token against the ring cache
        qpos = pos.expand(B)
        q = rope(q, qpos[:, None], cfg.rope_theta)
        kk = rope(kk, qpos[:, None], cfg.rope_theta)
        ck, cv = kv_cache
        C = ck.shape[1]
        slot = (pos % C).reshape(1).long()
        ck.index_copy_(1, slot, kk.to(ck.dtype))
        cv.index_copy_(1, slot, vv.to(cv.dtype))
        cpos = _slot_positions(pos + 1, C)[None].expand(B, C)
        att = decode_attention(q, ck, cv, cpos, qpos,
                               window=cfg.sliding_window)

    out = matmul_f32(att.reshape(B, S, -1), p["wo"].reshape(-1, d))
    return out.to(x.dtype)


def _dense_block(p, x, cfg, kv_cache, pos, use_kernels: bool):
    x = x + _attn_apply(p["attn"], x, cfg, kv_cache, pos, use_kernels)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + mlp_apply(p["mlp"], h, cfg.mlp)


def _stacked_layers(params, x, cfg, cache, pos, use_kernels: bool,
                    remat: bool = False):
    """The dense and ssm layer stacks: one block a layer, its cache
    entries written in place.  ``remat`` (a dense scoring pass, checked
    by :func:`forward`): each block is recomputed in the backward instead
    of keeping its activations."""
    for i in range(cfg.num_layers):
        p_l = tree_map(lambda a: a[i], params["blocks"])
        if remat:
            x = checkpoint(_dense_block, p_l, x, cfg, None, pos,
                           use_kernels, use_reentrant=False)
        elif cfg.family == "ssm":
            st = None if cache is None else tuple(a[i] for a in cache.rwkv)
            x, new_st = rwkv_block(p_l, x, st, cfg.rwkv_head_dim,
                                   cfg.norm_eps, use_kernels)
            if cache is not None:
                for a, b in zip(st, new_st):
                    a.copy_(b)
        else:
            kv_l = None if cache is None else (cache.attn_k[i],
                                               cache.attn_v[i])
            x = _dense_block(p_l, x, cfg, kv_l, pos, use_kernels)
    return x


def _hybrid_layers(params, x, cfg, cache, pos, use_kernels: bool):
    """zamba2's layer stack: per superblock the shared attention block
    (the same ``params["shared_attn"]`` each time, with the superblock's
    K/V slot), then its k Mamba2 layers, their states written in
    place."""
    k = cfg.attn_every
    sa = params["shared_attn"]  # a dense block, its attention leaves on top
    shared = {"attn": sa, "ln2": sa["ln2"], "mlp": sa["mlp"]}
    for sb in range(cfg.num_layers // k):
        kv = None if cache is None else (cache.attn_k[sb], cache.attn_v[sb])
        x = _dense_block(shared, x, cfg, kv, pos, use_kernels)
        for j in range(k):
            p_l = tree_map(lambda a: a[sb, j], params["blocks"])
            st = None if cache is None else tuple(a[sb, j]
                                                  for a in cache.mamba)
            x, new_st = mamba_block(p_l, x, st, cfg, use_kernels)
            if cache is not None:
                for a, b in zip(st, new_st):
                    a.copy_(b)
    return x


# --------------------------------------------------------------------------
# Forward and serving.
# --------------------------------------------------------------------------

def forward(params, cfg: ModelConfig, batch: dict, *, cache: Cache = None,
            use_kernels: bool = True, remat: bool = False):
    """Returns (hidden (B, S, d), new_cache, aux dict).

    batch: {"tokens": (B, S)}.  cache=None -> scoring (no cache written);
    cache -> prefill (S > 1) or decode (S == 1) into the cache, in place:
    the ring KV cache (dense), each layer's recurrent state (ssm, which
    continues from the cache's state) or both (hybrid: a prefill restarts
    the conv and continues the SSD state).  ``use_kernels`` reaches the
    prefill's kernels, the flash attention (dense, hybrid), the WKV6
    recurrence (ssm) and the SSD scan (hybrid): the kernel on CUDA tensors
    when True, its plain version when False.  ``remat`` recomputes each
    dense layer in the backward of a scoring pass (the training forward,
    :func:`lm_loss`); asked of another family or with a cache, it
    raises."""
    _check_ported(cfg)
    if remat:
        check_trainable(cfg)
        if cache is not None:
            raise ValueError("remat recomputes a scoring pass: no cache")
    tokens = batch["tokens"]
    B, S = tokens.shape
    x, ovf = embed_lookup(params["embed"], tokens, cfg.routed_embedding)
    pos = cache.pos if cache is not None else \
        torch.zeros((), dtype=torch.int32, device=tokens.device)
    if cfg.family == "hybrid":
        x = _hybrid_layers(params, x, cfg, cache, pos, use_kernels)
    else:
        x = _stacked_layers(params, x, cfg, cache, pos, use_kernels, remat)
    new_cache = cache
    if cache is not None:
        new_cache = cache._replace(pos=cache.pos + S)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    aux = {"moe_aux": torch.zeros((), dtype=torch.float32,
                                  device=x.device), "overflow": ovf}
    return x, new_cache, aux


def serve_step(params, cfg: ModelConfig, cache: Cache, tokens):
    """One decode step for the whole batch.  tokens: (B, 1) int.
    Returns (next_token (B,) int32, new_cache): the first maximal index of
    the float32 logits of the last position."""
    x, new_cache, _ = forward(params, cfg, {"tokens": tokens}, cache=cache)
    logits = matmul_f32(x[:, -1:], params["lm_head"])
    nxt = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
    return nxt, new_cache


def prefill(params, cfg: ModelConfig, cache: Cache, batch: dict, *,
            use_kernels: bool = True):
    """Fill the cache with a prompt, as the reference: a dense prompt takes
    positions 0..S-1 whatever ``cache.pos`` is; an ssm prompt continues
    from the cache's recurrent state (a new cache holds zeros); a hybrid
    prompt does both, its attention at positions 0..S-1, its conv from
    zero padding and its SSD from the cache's state.  Returns
    (last-position hidden, cache)."""
    x, new_cache, _ = forward(params, cfg, batch, cache=cache,
                              use_kernels=use_kernels)
    return x[:, -1], new_cache


# --------------------------------------------------------------------------
# Loss (chunked logits).
# --------------------------------------------------------------------------

def chunked_xent(x, w_head, labels, mask, chunk: int = 512,
                 z_loss: float = 1e-4):
    """Cross entropy against the logits, taken ``chunk`` positions at a
    time (outside autograd the whole (B, S, V) float32 logits never exist
    at once; under it each chunk's are kept for the backward, as the
    reference's scan keeps them); a sequence that is not a multiple of
    ``chunk`` is one chunk, as in the reference.  Adds ``z_loss`` times
    the mean squared logsumexp.

    x: (B, S, d); w_head: (d, V_pad); labels: (B, S) int; mask: (B, S)
    float32."""
    S = x.shape[1]
    chunk = min(chunk, S)
    if S % chunk:
        chunk = S
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    zt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, chunk):
        logits = matmul_f32(x[:, c0:c0 + chunk], w_head)
        lse = torch.logsumexp(logits, dim=-1)
        picked = logits.gather(
            -1, labels[:, c0:c0 + chunk, None].long())[..., 0]
        mc = mask[:, c0:c0 + chunk]
        tot = tot + ((lse - picked) * mc).sum()
        zt = zt + (lse * lse * mc).sum()
    denom = torch.clamp_min(mask.sum(), 1).to(torch.float32)
    return tot / denom + z_loss * zt / denom


def lm_loss(params, cfg: ModelConfig, batch: dict, *, remat: bool = True,
            use_kernels: bool = True, aux_weight: float = 1e-2):
    """Causal LM loss of the dense family; returns (loss, metrics).  Token
    t + 1 is predicted at position t; a negative label is masked out.
    ``use_kernels`` reaches the attention: the flash kernel and its
    backward kernel on CUDA tensors, their plain versions otherwise (the
    reference's ``lm_loss`` runs its plain ``blockwise_attention``)."""
    check_trainable(cfg)
    x, _, aux = forward(params, cfg, batch, remat=remat,
                        use_kernels=use_kernels)
    tokens = batch["tokens"]
    hx = x[:, :-1] if tokens.shape[1] > 1 else x
    labels = tokens[:, 1:]
    mask = (labels >= 0).to(torch.float32)
    loss = chunked_xent(hx, params["lm_head"], torch.clamp_min(labels, 0),
                        mask)
    total = loss + aux_weight * aux["moe_aux"]
    return total, {"xent": loss, "moe_aux": aux["moe_aux"],
                   "overflow": aux["overflow"]}


# --------------------------------------------------------------------------
# Carrying the JAX package's trees across (tests).
# --------------------------------------------------------------------------

def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: move the bits
        return torch.from_numpy(a.view(np.int16).copy()) \
            .view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(tree, device="cuda"):
    """The JAX package's params (nested dicts of numpy arrays, same keys
    and layouts) as the port's tensors on ``device``."""
    return tree_map(lambda a: _tensor(a, device), tree)


def opt_state_from_numpy(state, device="cuda"):
    """The JAX package's ``OptState`` (its fields as numpy arrays or
    trees of them; ``ef`` may be None) as the port's
    :class:`repro_torch.optim.adamw.OptState`."""
    return OptState(*(tree_map(lambda a: _tensor(a, device), f)
                      for f in state))


def cache_from_numpy(cache, device="cuda"):
    """The JAX package's ``Cache`` (its fields as numpy arrays) as the
    port's :class:`Cache`."""
    return Cache(*(tree_map(lambda a: _tensor(a, device), f)
                   for f in cache))
