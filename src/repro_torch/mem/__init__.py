"""Memory spaces for tile buffers (port of ``repro.mem``).

Every engine buffer is declared in a space of the *modelled Dalorex tile*
and allocated through :func:`alloc`, which rejects a space that cannot
hold the buffer's kind at config time, naming the buffer.
``Program.validate`` checks each tile's declared footprint against the
space budgets with :func:`check_budgets`.

The capacities below are parameters of the modelled tile (its scratchpad
and its backing store), not sizes of any real device: they decide which
configurations the model accepts, exactly as in the reference, and have
nothing to do with where the port's tensors live on the GPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: Buffer kinds a space may be asked to hold.
KINDS = ("queue", "edge", "state")


@dataclasses.dataclass(frozen=True)
class MemSpace:
    """One addressable memory space of a modelled tile.

    ``capacity_bytes`` is the per-tile budget.  ``window`` is the minimum
    DMA transfer granularity in *elements* for streamed spaces (VMEM is
    word-random: window 1).  ``kinds`` lists the buffer kinds allocatable
    here.  ``streamed`` marks spaces reached only through windowed DMA.
    """

    name: str
    capacity_bytes: int
    window: int = 1
    kinds: tuple = KINDS
    streamed: bool = False


#: The registry: the modelled tile's scratchpad (16 MiB budget), its
#: streamed backing store (8 GiB, edge shards only) and a declared future
#: host tier that nothing may be allocated in yet.  Model parameters.
VMEM = MemSpace("vmem", capacity_bytes=16 * 1024 * 1024)
HBM = MemSpace("hbm", capacity_bytes=8 * 1024 * 1024 * 1024, window=128,
               kinds=("edge",), streamed=True)
HOST = MemSpace("host", capacity_bytes=64 * 1024 * 1024 * 1024, window=4096,
                kinds=(), streamed=True)

_REGISTRY: dict = {}


def register(space: MemSpace) -> MemSpace:
    """Add (or replace) a space in the registry; returns it."""
    _REGISTRY[space.name] = space
    return space


for _s in (VMEM, HBM, HOST):
    register(_s)


def get_space(name: str) -> MemSpace:
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown memory space {name!r}; registered: "
            f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def check_alloc(space: str, kind: str, label: str) -> MemSpace:
    """Validate that buffer ``label`` of ``kind`` may live in ``space``;
    raises ``ValueError`` naming the buffer and the space."""
    sp = get_space(space)
    if kind not in KINDS:
        raise ValueError(f"unknown buffer kind {kind!r}")
    if kind not in sp.kinds:
        holds = f"holds only {sp.kinds}" if sp.kinds else \
            "is not yet allocatable (a declared future tier)"
        raise ValueError(
            f"buffer {label!r} (kind {kind!r}) cannot live in memory "
            f"space {sp.name!r}: {sp.name!r} {holds}")
    return sp


def alloc(space: str, kind: str, shape: tuple, dtype, label: str,
          device="cuda") -> torch.Tensor:
    """A zeroed ``(shape, dtype)`` tensor on ``device`` after
    :func:`check_alloc` — the one place engine buffers are created."""
    check_alloc(space, kind, label)
    return torch.zeros(shape, dtype=dtype, device=device)


def footprint_bytes(shape: tuple, dtype) -> int:
    """Declared size of one buffer, in bytes (``dtype``: numpy or torch)."""
    itemsize = dtype.itemsize if isinstance(dtype, torch.dtype) else \
        np.dtype(dtype).itemsize
    return int(np.prod(shape, dtype=np.int64)) * itemsize


def space_budget(space: str, override_bytes: int = 0) -> int:
    """The per-tile capacity to validate against: the registry's, unless
    the run overrides it (``EngineConfig.vmem_limit_bytes``)."""
    return int(override_bytes) if override_bytes else \
        get_space(space).capacity_bytes


def resolve_window(cfg_window: int, max_t2: int) -> int:
    """The DMA window (elements) for a streamed edge shard: ``0``
    auto-sizes to the next power of two >= MAX_T2 and >= the space's
    granularity; an explicit window below MAX_T2 is a config error."""
    gran = get_space("hbm").window
    if cfg_window == 0:
        w = 1 << (max(int(max_t2), 1) - 1).bit_length()
        return max(w, gran)
    if cfg_window < max_t2:
        raise ValueError(
            f"hbm_window={cfg_window} < max_t2={max_t2}: a DMA window "
            f"must cover one bounded range message (the double-buffer "
            f"invariant); use hbm_window=0 to auto-size")
    return int(cfg_window)


def check_budgets(program_name: str, decls: list, vmem_limit_bytes: int = 0):
    """Validate per-tile declared footprints (``(label, space, nbytes)``
    triples) against each space's budget; raises ``ValueError`` naming the
    program, the space, the totals and the largest buffer."""
    by_space: dict = {}
    for label, space, nbytes in decls:
        by_space.setdefault(space, []).append((label, int(nbytes)))
    for space, bufs in sorted(by_space.items()):
        budget = space_budget(
            space, vmem_limit_bytes if space == "vmem" else 0)
        total = sum(b for _, b in bufs)
        if total > budget:
            big_label, big_bytes = max(bufs, key=lambda lb: lb[1])
            raise ValueError(
                f"program {program_name!r}: memory space {space!r} over "
                f"budget on a tile: declared buffers total {total} B > "
                f"{budget} B capacity; largest buffer is {big_label!r} "
                f"({big_bytes} B in {space!r}) — move it to another "
                f"space or raise the budget")
