"""Plain PyTorch versions of the Mamba2 SSD recurrence (port of
``repro.kernels.mamba2.ref``): one decode step, the chunked closed form
(the plain version of the Hopper kernel in ``kernel.py``) and the
step-by-step scan that both must match.

Per head with head width P and state width N, a scalar decay per head and
step a_t = exp(-exp(A_log) * dt_t):

    h_t = a_t h_{t-1} + dt_t * x_t B_t^T        (state P x N)
    y_t = h_t C_t

Within a chunk, with L_t the inclusive cumsum of log a,

    y_t = C_t (exp(L_t) h_prev)^T
        + sum_{s<=t} exp(L_t - L_s) dt_s (C_t . B_s) x_s
    h'  = exp(L_last) h_prev + sum_s exp(L_last - L_s) dt_s x_s B_s^T

The per-step log decay is clipped to [-4, 0], as the reference's.  B and
C are shared across heads.  Everything is float32.
"""
from __future__ import annotations

import torch


def _log_decay(dt, a_log):
    """clip(-exp(a_log) * dt, -4, 0); dt (..., H)."""
    return torch.clamp(-torch.exp(a_log) * dt, -4.0, 0.0)


def ssd_step(state, x, dt, a_log, Bv, Cv):
    """One decode step.  state: (B, H, P, N); x: (B, H, P); dt: (B, H);
    a_log: (H,); Bv, Cv: (B, N).  Returns (new_state, y (B, H, P))."""
    a = torch.exp(_log_decay(dt, a_log[None]))               # (B, H)
    new_state = (a[..., None, None] * state
                 + (dt[..., None] * x)[..., None] * Bv[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", new_state, Cv)
    return new_state, y


def ssd_chunked(x, dt, a_log, Bm, Cm, state0=None, chunk: int = 64):
    """x: (B, S, H, P); dt: (B, S, H); a_log: (H,); Bm, Cm: (B, S, N).
    Returns (y (B, S, H, P), final state (B, H, P, N)).  Raises
    ValueError where the reference asserts: S not a multiple of
    min(chunk, S)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"ssd_chunked: S={S} is not a multiple of the "
                         f"chunk {chunk}")
    state = state0 if state0 is not None else torch.zeros(
        (B, H, P, N), dtype=torch.float32, device=x.device)
    loga = _log_decay(dt, a_log[None, None])                 # (B, S, H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    ys = []
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        xb, db, bb, cb = x[:, sl], dt[:, sl], Bm[:, sl], Cm[:, sl]
        L = torch.cumsum(loga[:, sl], dim=1)                 # (B, C, H)
        # inter-chunk
        y_inter = torch.einsum("bcn,bhpn,bch->bchp", cb, state,
                               torch.exp(L))
        # intra-chunk (s <= t), selected, not masked by a product: above
        # the diagonal exp(L_t - L_s) may overflow
        cb_dot_bb = torch.einsum("btn,bsn->bts", cb, bb)     # (B, t, s)
        decay = torch.exp(L[:, :, None] - L[:, None])        # (B, t, s, H)
        att = torch.where(tri[None, :, :, None],
                          cb_dot_bb[..., None] * decay, 0.0)
        y_intra = torch.einsum("btsh,bsh,bshp->bthp", att, db, xb)
        ys.append(y_inter + y_intra)
        # state update
        dec_all = torch.exp(L[:, -1])                        # (B, H)
        wgt = torch.exp(L[:, -1][:, None] - L) * db          # (B, C, H)
        state = dec_all[..., None, None] * state + torch.einsum(
            "bch,bchp,bcn->bhpn", wgt, xb, bb)
    return torch.cat(ys, dim=1), state


def ssd_scan_oracle(x, dt, a_log, Bm, Cm, state0=None):
    """Step-by-step scan: the ground truth the chunked form must match."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    state = state0 if state0 is not None else torch.zeros(
        (B, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        state, y = ssd_step(state, x[:, t], dt[:, t], a_log, Bm[:, t],
                            Cm[:, t])
        ys.append(y)
    return torch.stack(ys, dim=1), state
