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

The SPMD backends run the same stages with one tile a process, over a
``torch.distributed`` group (an axis of a
:class:`~torch.distributed.device_mesh.DeviceMesh`, see
:func:`mesh_axis`): :class:`AxisComm` is the reference's ``AxisComm``
(one tile-led row a process, ``me`` the rank) and :class:`LaneAxisComm`
its serving-lane form (B rows a process, one a lane, all of its own
tile).  Their all-to-all is ``all_to_all_single`` on the reference's
tiled layout; integer and flag reductions are ``all_reduce``; a float
reduction is an ``all_gather`` followed by :class:`LocalComm`'s own sum or
max over the gathered tiles, in tile order, so its bits (signed zeros
and NaN included) are the emulation's, where a ring ``all_reduce`` would
add in another order.  Every global comes out the same on every process,
so the host loops that read them take the same branches everywhere.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class LocalComm:
    """T emulated tiles on one device."""

    size: int
    device: torch.device = torch.device("cpu")
    lane_led = False  # globals are one copy (LaneComm: one a lane)
    tile0 = 0         # the tile of row 0 (the SPMD comms: the rank)

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
    tile0 = 0

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


# --------------------------------------------------------------------------
# SPMD: one tile a process over a torch.distributed group.
# --------------------------------------------------------------------------

def mesh_axis(mesh, axis: str):
    """``(group, size, rank, device)`` of ``axis`` of a DeviceMesh: the
    axis's process group, its size, this process's coordinate on it and
    this process's device (the current CUDA device on a ``"cuda"`` mesh,
    which raises without a GPU: nothing falls back to the CPU)."""
    if mesh.device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a 'cuda' mesh needs a CUDA device; build a "
                               "'cpu' mesh to run over gloo")
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device(mesh.device_type)
    dim = mesh.mesh_dim_names.index(axis)
    return (mesh.get_group(axis), mesh.size(dim), mesh.get_local_rank(axis),
            device)


def _wire(x: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor the backends take: flags travel as bytes."""
    x = x.contiguous()
    return x.view(torch.uint8) if x.dtype == torch.bool else x


# the concatenating all-gather (named all_gather_into_tensor before 2.13)
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def gather_ranks(group, size: int, x: torch.Tensor) -> torch.Tensor:
    """(size, *x.shape): every rank's ``x``, in rank order."""
    w = _wire(x)
    out = torch.empty((size * w.shape[0],) + tuple(w.shape[1:]),
                      dtype=w.dtype, device=w.device)
    _all_gather(out, w, group=group)
    out = out.view((size,) + tuple(w.shape))
    return out.view(torch.bool) if x.dtype == torch.bool else out


def _reduce(group, x: torch.Tensor, op) -> torch.Tensor:
    """``all_reduce`` of a copy of an integer or flag tensor (a flag sum is
    an OR, as ``sum(dtype=bool)`` is)."""
    y = x.clone(memory_format=torch.contiguous_format)
    if y.dtype == torch.bool:
        dist.all_reduce(y.view(torch.uint8), op=dist.ReduceOp.MAX,
                        group=group)
    else:
        dist.all_reduce(y, op=op, group=group)
    return y


def exchange_rows(group, x: torch.Tensor) -> torch.Tensor:
    """``all_to_all_single`` along dim 0: the i-th of ``size`` equal row
    blocks goes to rank i, and block t of the result came from rank t."""
    w = _wire(x)
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=group)
    return out.view(torch.bool) if x.dtype == torch.bool else out


@functools.lru_cache(maxsize=64)
def _rank_ids(rank: int, n: int, device: str) -> torch.Tensor:
    return torch.full((n,), rank, dtype=torch.int32, device=device)


@dataclasses.dataclass(frozen=True, eq=False)
class LaneAxisComm:
    """:class:`LaneComm` under SPMD: each process runs all B lanes of its
    own tile (the reference's ``spmd_lanes_call`` layout), so a tile-led
    tensor has ``rows = B`` rows, one a lane, ``me`` is the rank repeated
    B times, a collective acts across the processes lane by lane, and a
    global is lane-led ``(B, ...)`` as it comes."""

    group: object
    size: int
    lanes: int
    rank: int
    device: torch.device = torch.device("cpu")
    lane_led = True

    @property
    def rows(self) -> int:
        return self.lanes

    @property
    def tile0(self) -> int:
        return self.rank

    def a2a(self, x: torch.Tensor) -> torch.Tensor:
        # x: (B, T*s, ...): regrouped by destination (T, B, s, ...),
        # exchanged, and regrouped back by lane
        b, t = self.lanes, self.size
        s = x.shape[1] // t
        rest = tuple(x.shape[2:])
        y = x.reshape((b, t, s) + rest).transpose(0, 1)
        got = exchange_rows(self.group, y.reshape((t * b, s) + rest))
        return got.view((t, b, s) + rest).transpose(0, 1) \
            .reshape((b, t * s) + rest)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype.is_floating_point:
            return self.all_gather(x).sum(dim=1, dtype=x.dtype)
        return _reduce(self.group, x, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype.is_floating_point:
            return self.all_gather(x).amax(dim=1)
        return _reduce(self.group, x, dist.ReduceOp.MAX)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        # (B, ...) -> (B, T, ...): each lane sees its own lane's stack
        return gather_ranks(self.group, self.size, x).transpose(0, 1) \
            .contiguous()

    def my_id(self) -> torch.Tensor:
        return _rank_ids(self.rank, self.lanes, str(self.device))

    def run(self, fn, *args):
        return fn(self.my_id(), *args)

    def to_global(self, x: torch.Tensor) -> torch.Tensor:
        """A lane-reduced value is one copy a lane already: (B, ...)."""
        return x


class AxisComm(LaneAxisComm):
    """One tile a process: the reference's ``AxisComm`` over a
    ``torch.distributed`` group of ``size`` processes, this one tile
    ``rank``.  It is :class:`LaneAxisComm` of one lane whose globals are
    one copy: a tile-led tensor is ``(1, ...)`` (``rows == 1``), so the
    batched stages written for :class:`LocalComm` run unchanged, ``me`` is
    ``[rank]`` and a global is row 0 of a reduced value."""

    lane_led = False

    def __init__(self, group, size: int, rank: int,
                 device: torch.device = torch.device("cpu")):
        super().__init__(group, size, 1, rank, device)

    def to_global(self, x: torch.Tensor) -> torch.Tensor:
        return x[0]
