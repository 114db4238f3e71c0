"""Plain PyTorch versions of the RWKV6 (Finch) WKV recurrence (port of
``repro.kernels.rwkv6.ref``): one decode step, the chunked closed form
(the plain version of the Hopper kernel in ``kernel.py``) and the
step-by-step scan that both must match.

Per head with key/value width K and a data-dependent per-channel decay
w_t in (0, 1):

    S_t = diag(w_t) S_{t-1} + k_t^T v_t          (state K x K)
    y_t = r_t S_{t-1} + (r_t . (u * k_t)) v_t    (u = per-channel bonus)

Within a chunk of C steps, with L_t the inclusive cumsum of log w and
Pex_t = L_t - log w_t (exclusive),

    y_t = (r_t * exp(Pex_t)) S_prev
        + sum_{s<t} (r_t . (k_s * exp(Pex_t - L_s))) v_s
        + (r_t . (u * k_t)) v_t
    S'  = diag(exp(L_{C-1})) S_prev + sum_s diag(exp(L_{C-1} - L_s)) k_s^T v_s

Everything is float32.
"""
from __future__ import annotations

import torch


def wkv6_step(state, r, k, v, w, u):
    """One decode step.  state: (B, H, K, K); r, k, v, w: (B, H, K);
    u: (H, K).  Returns (new_state, y (B, H, K))."""
    y = torch.einsum("bhk,bhkv->bhv", r, state) \
        + torch.einsum("bhk,bhk,bhv->bhv", r, u[None] * k, v)
    new_state = w[..., None] * state + k[..., None] * v[..., None, :]
    return new_state, y


def wkv6_chunked(r, k, v, w_log, u, state0=None, chunk: int = 64):
    """r, k, v: (B, S, H, K) float32; w_log: (B, S, H, K) = log decay
    (<= 0); u: (H, K).  Returns (y (B, S, H, K), final state
    (B, H, K, K))."""
    B, S, H, K = r.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"wkv6_chunked: S={S} is not a multiple of the "
                         f"chunk {chunk}")
    n = S // chunk
    state = state0 if state0 is not None else torch.zeros(
        (B, H, K, K), dtype=torch.float32, device=r.device)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), diagonal=-1)
    ys = []
    for c in range(n):
        sl = slice(c * chunk, (c + 1) * chunk)
        rb, kb, vb, wb = r[:, sl], k[:, sl], v[:, sl], w_log[:, sl]
        L = torch.cumsum(wb, dim=1)             # inclusive
        pex = L - wb                            # exclusive
        r_in = rb * torch.exp(pex)
        # inter-chunk: y += (r * exp(Pex)) @ S_prev
        y_inter = torch.einsum("bchk,bhkv->bchv", r_in, state)
        # intra-chunk, strictly lower triangular (selected, not masked by
        # a product: exp(-L) may be large above the diagonal)
        att = torch.einsum("bthk,bshk->bhts", r_in, kb * torch.exp(-L))
        att = torch.where(tri, att, 0.0)
        y_intra = torch.einsum("bhts,bshv->bthv", att, vb)
        # diagonal bonus term
        y_diag = torch.einsum("bchk,bchk,bchv->bchv", rb, u[None, None] * kb,
                              vb)
        ys.append(y_inter + y_intra + y_diag)
        # state update
        decay_all = torch.exp(L[:, -1])         # (B, H, K)
        k_dec = kb * torch.exp(L[:, -1][:, None] - L)
        state = decay_all[..., None] * state + torch.einsum(
            "bchk,bchv->bhkv", k_dec, vb)
    return torch.cat(ys, dim=1), state


def wkv6_scan_oracle(r, k, v, w_log, u, state0=None):
    """Step-by-step scan: the ground truth the chunked form must match."""
    B, S, H, K = r.shape
    state = state0 if state0 is not None else torch.zeros(
        (B, H, K, K), dtype=torch.float32, device=r.device)
    w = torch.exp(w_log)
    ys = []
    for t in range(S):
        state, y = wkv6_step(state, r[:, t], k[:, t], v[:, t], w[:, t], u)
        ys.append(y)
    return torch.stack(ys, dim=1), state
