"""Tile emulation on one device (port of ``repro.core.comm.LocalComm``).

Tensors carry a leading T axis.  A per-tile stage is written batched over
that axis and :meth:`LocalComm.run` calls it ONCE with ``me = arange(T)``
(no vmap): a kernel grid over T replaces such a stage directly.  The
all-to-all is a reshape and a transpose, following the reference's
convention: send buffers are ``(T, T*s, ...)`` with rows ``[d*s:(d+1)*s]``
addressed to tile ``d``; after the exchange, rows ``[t*s:(t+1)*s]`` hold
what tile ``t`` sent.

:class:`LaneComm` runs B independent query lanes of T tiles each on
the same device (the serving lanes of :mod:`repro_torch.serve`): tensors
carry B * T lane-major rows, ``me`` is the tile within its lane, and
every collective acts within each lane's T rows, so a stage written for
:class:`LocalComm` runs all B lanes in one call and no message crosses
lanes.

The SPMD backend (``AxisComm`` over ``torch.distributed``) is a later
slice (ROADMAP.md, "SPMD").
"""
from __future__ import annotations

import dataclasses
import functools

import torch


@dataclasses.dataclass(frozen=True)
class LocalComm:
    """T emulated tiles on one device."""

    size: int
    device: torch.device = torch.device("cpu")
    lane_led = False  # globals are one copy (LaneComm: one a lane)

    @property
    def rows(self) -> int:
        """Rows of a tile-led tensor: the T tiles."""
        return self.size

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


@functools.lru_cache(maxsize=16)
def _lane_ids(T: int, lanes: int, device: str) -> torch.Tensor:
    return torch.arange(T, dtype=torch.int32, device=device).repeat(lanes)


@dataclasses.dataclass(frozen=True)
class LaneComm:
    """B query lanes of T emulated tiles each, on one device.

    A tile-led tensor has ``rows = B * T`` lane-major rows (row ``b * T +
    t`` is tile ``t`` of lane ``b``); ``size`` is T, the tiles a message
    can reach.  Each collective is :class:`LocalComm`'s within every
    lane's T rows, and :meth:`to_global` keeps one copy a lane, so a
    global comes out lane-led ``(B, ...)``."""

    size: int
    lanes: int
    device: torch.device = torch.device("cpu")
    lane_led = True

    @property
    def rows(self) -> int:
        return self.lanes * self.size

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape((self.lanes, self.size) + tuple(x.shape[1:]))

    def a2a(self, x: torch.Tensor) -> torch.Tensor:
        # x: (B*T, T*s, ...): within each lane, LocalComm's transpose
        b, t = self.lanes, self.size
        s = x.shape[1] // t
        rest = tuple(x.shape[2:])
        y = x.reshape((b, t, t, s) + rest).transpose(1, 2)
        return y.reshape((b * t, t * s) + rest)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        y = self._split(x)
        return y.sum(dim=1, keepdim=True, dtype=x.dtype).expand(y.shape) \
            .reshape(x.shape)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        y = self._split(x)
        return y.amax(dim=1, keepdim=True).expand(y.shape).reshape(x.shape)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        # (B*T, ...) -> (B*T, T, ...): every tile sees its own lane's stack
        y = self._split(x)
        b, t = self.lanes, self.size
        return y[:, None].expand((b, t) + tuple(y.shape[1:])) \
            .reshape((b * t, t) + tuple(x.shape[1:]))

    def my_id(self) -> torch.Tensor:
        """Each row's tile within its lane (one tensor a comm, read
        only)."""
        return _lane_ids(self.size, self.lanes, str(self.device))

    def run(self, fn, *args):
        return fn(self.my_id(), *args)

    def to_global(self, x: torch.Tensor) -> torch.Tensor:
        """One copy a lane of a lane-broadcast value: (B, ...)."""
        return self._split(x)[:, 0]
