"""AdamW with float32 master weights, global-norm clipping, learning-rate
schedules and an optional int8 error-feedback gradient-compression hook
(port of ``repro.optim.adamw``).

Memory a parameter: its own dtype (2 bytes in bfloat16) plus 12 bytes of
float32 master, first and second moments.  The reference's update is
functional; here :func:`apply_updates` writes the master, the moments and
the parameters in place, a slab of a stacked leaf at a time, so that its
temporaries stay near one layer's slice of the largest leaf (granite-3-2b's
stacked MLP leaf is 671 M elements: one float32 copy of it is 2.7 GB).
The arithmetic is the reference's, step by step, in float32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.parallel.sharding import tree_map

# elements of the slab of a leaf that one update pass takes at a time
SLAB = 1 << 24


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"  # cosine | linear | constant
    min_lr_ratio: float = 0.1
    compress_grads: bool = False  # int8 error-feedback DP all-reduce


class OptState(NamedTuple):
    step: torch.Tensor   # () int32
    master: dict         # float32 master weights
    mu: dict
    nu: dict
    ef: dict | None      # error-feedback residuals (compression only)


def leaves(tree) -> list:
    """The tensors of a tree, in :func:`tree_map`'s (sorted-key) order."""
    out = []
    tree_map(out.append, tree)
    return out


def schedule_lr(oc: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), float32: linear warmup,
    then a cosine or linear decay to ``min_lr_ratio``, or constant."""
    step = step.to(torch.float32)
    warm = torch.clamp_max(step / max(oc.warmup_steps, 1), 1.0)
    frac = torch.clamp((step - oc.warmup_steps)
                       / max(oc.total_steps - oc.warmup_steps, 1), 0.0, 1.0)
    if oc.schedule == "cosine":
        decay = oc.min_lr_ratio + (1 - oc.min_lr_ratio) * 0.5 * (
            1 + torch.cos(math.pi * frac))
    elif oc.schedule == "linear":
        decay = oc.min_lr_ratio + (1 - oc.min_lr_ratio) * (1 - frac)
    else:
        decay = 1.0
    return oc.lr * warm * decay


def init(params, oc: OptConfig) -> OptState:
    """Float32 master copies (never aliasing the parameters), zero moments,
    and zero residuals when gradients are compressed."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    f32 = lambda p: p.detach().to(torch.float32, copy=True)  # noqa: E731
    step = torch.zeros((), dtype=torch.int32,
                       device=leaves(params)[0].device)
    ef = tree_map(zeros, params) if oc.compress_grads else None
    return OptState(step, tree_map(f32, params), tree_map(zeros, params),
                    tree_map(zeros, params), ef)


def _slabs(*ts):
    """Matching views of ``ts`` (same shape), a slab of at most SLAB
    elements (or one index of the leading axis) at a time."""
    t = ts[0]
    if t.dim() == 0 or t.numel() <= SLAB:
        yield ts
        return
    rows = max(1, SLAB // max(t[0].numel(), 1))
    for i in range(0, t.shape[0], rows):
        yield tuple(x[i:i + rows] for x in ts)


def _square_sum(g) -> torch.Tensor:
    tot = torch.zeros((), dtype=torch.float32, device=g.device)
    for (s,) in _slabs(g):
        x = s.to(torch.float32)
        tot = tot + torch.sum(x * x)
    return tot


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 squares."""
    tot = 0
    for g in leaves(tree):
        tot = tot + _square_sum(g)
    return torch.sqrt(tot)


@torch.no_grad()
def apply_updates(params, state: OptState, grads, oc: OptConfig):
    """One AdamW step.  Returns (params, state, metrics); the parameters,
    the master and the moments are updated in place and returned."""
    step = state.step + 1
    gn = global_norm(grads)
    scale = torch.clamp_max(oc.clip_norm / torch.clamp_min(gn, 1e-9), 1.0) \
        if oc.clip_norm else 1.0
    lr = schedule_lr(oc, step)
    b1, b2 = oc.beta1, oc.beta2
    c1 = 1 - torch.pow(b1, step.to(torch.float32))
    c2 = 1 - torch.pow(b2, step.to(torch.float32))
    for p, g, m, mu, nu in zip(leaves(params), leaves(grads),
                               leaves(state.master), leaves(state.mu),
                               leaves(state.nu)):
        for ps, gs, ms, mus, nus in _slabs(p, g, m, mu, nu):
            g32 = gs.to(torch.float32) * scale
            mus.copy_(b1 * mus + (1 - b1) * g32)
            nus.copy_(b2 * nus + (1 - b2) * g32 * g32)
            upd = (mus / c1) / (torch.sqrt(nus / c2) + oc.eps) \
                + oc.weight_decay * ms
            ms.sub_(lr * upd)
            ps.copy_(ms)
    return params, OptState(step, state.master, state.mu, state.nu,
                            state.ef), {"grad_norm": gn, "lr": lr}
