"""The Dalorex task-routing primitive (port of ``repro.core.routing``).

A task message is a row of int32 flits whose head flit is a global array
index; its owner under the equal-chunk distribution is the route (the
paper's headerless NoC), and a negative head flit marks an empty slot.
:func:`route_tasks` is one network round: bin by owner with FIFO slot
claims up to ``capacity`` per destination, one all-to-all, and the
messages that did not fit come back as spill for local re-queueing.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.queues import histogram, occurrence_index

EMPTY = -1  # head-flit value marking an empty network slot


class Routed(NamedTuple):
    """Result of one routing round, batched over tiles.

    recv:        (T, T*capacity, W) int32 — received messages, grouped by
                 source tile; empty slots have head flit < 0.
    recv_valid:  (T, T*capacity) bool — decoded from the head flit.
    spill:       (T, N, W) int32 — local copies of messages that did not
                 fit.
    spill_valid: (T, N) bool.
    sent:        (T,) int32 — messages actually sent by each tile.
    """

    recv: torch.Tensor
    recv_valid: torch.Tensor
    spill: torch.Tensor
    spill_valid: torch.Tensor
    sent: torch.Tensor


def bin_by_owner(msgs, valid, dest, num_shards: int, capacity: int):
    """Pack (T, N, W) ``msgs`` into per-destination slots of a
    (T, num_shards*capacity, W) send buffer.

    Returns (send_buf, spill_msgs, spill_valid, n_sent).  FIFO order within
    each destination is kept; messages beyond ``capacity`` for a
    destination come back as spill (masked in place).  Empty slots have
    head flit -1.
    """
    T, n, w = msgs.shape
    occ = occurrence_index(dest, valid, num_shards)  # n for invalid rows
    fits = valid & (occ < capacity)
    slot = torch.where(fits, dest * capacity + occ, num_shards * capacity)
    buf = torch.full((T, num_shards * capacity + 1, w), EMPTY,
                     dtype=torch.int32, device=msgs.device)
    # slot num_shards*capacity is the trash row: only non-fitting rows
    # collide there, and it is sliced off
    buf.scatter_(1, slot.to(torch.int64)[:, :, None].expand(-1, -1, w), msgs)
    spill_valid = valid & ~fits
    n_sent = fits.sum(dim=1, dtype=torch.int32)
    return buf[:, :-1], msgs, spill_valid, n_sent


def route_tasks(comm, msgs: torch.Tensor, valid: torch.Tensor,
                dest: torch.Tensor, capacity: int) -> Routed:
    """One Dalorex network round over ``comm`` (all tensors tile-led)."""
    T = comm.size

    def local_bin(_me, m, v, d):
        return bin_by_owner(m, v, d, T, capacity)

    buf, spill, spill_valid, n_sent = comm.run(local_bin, msgs, valid, dest)
    recv = comm.a2a(buf)
    return Routed(recv, recv[..., 0] >= 0, spill, spill_valid, n_sent)


def route_stats(comm, valid: torch.Tensor, dest: torch.Tensor,
                num_shards: int) -> torch.Tensor:
    """Per-destination message histogram, (T, num_shards) int32 (for NoC
    balance benchmarks)."""
    def local(_me, v, d):
        return histogram(d, v, num_shards)
    return comm.run(local, valid, dest)
