"""Tile emulation on one device (port of ``repro.core.comm.LocalComm``).

Tensors carry a leading T axis.  A per-tile stage is written batched over
that axis and :meth:`LocalComm.run` calls it ONCE with ``me = arange(T)``
(no vmap): a kernel grid over T replaces such a stage directly.  The
all-to-all is a reshape and a transpose, following the reference's
convention: send buffers are ``(T, T*s, ...)`` with rows ``[d*s:(d+1)*s]``
addressed to tile ``d``; after the exchange, rows ``[t*s:(t+1)*s]`` hold
what tile ``t`` sent.

The SPMD backend (``AxisComm`` over ``torch.distributed``) is a later
slice (ROADMAP.md, "SPMD").
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class LocalComm:
    """T emulated tiles on one device."""

    size: int
    device: torch.device = torch.device("cpu")

    def a2a(self, x: torch.Tensor) -> torch.Tensor:
        # x: (T, T*s, ...) -> (T, T*s, ...)
        t = self.size
        s = x.shape[1] // t
        y = x.reshape((t, t, s) + tuple(x.shape[2:])).transpose(0, 1)
        return y.reshape((t, t * s) + tuple(x.shape[2:]))

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """(T, ...) -> the sum over tiles, broadcast back to every tile
        (dtype kept: torch would widen an int32 sum to int64)."""
        return x.sum(dim=0, keepdim=True, dtype=x.dtype).expand(x.shape)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return x.amax(dim=0, keepdim=True).expand(x.shape)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        # (T, ...) -> (T, T, ...): every tile sees the full stack
        return x[None].expand((self.size,) + tuple(x.shape))

    def my_id(self) -> torch.Tensor:
        return torch.arange(self.size, dtype=torch.int32, device=self.device)

    def run(self, fn, *args):
        """Run a batched per-tile stage over all T tiles at once."""
        return fn(self.my_id(), *args)

    def to_global(self, x: torch.Tensor) -> torch.Tensor:
        """Collapse a broadcast (T, ...) per-tile value to one copy."""
        return x[0]
