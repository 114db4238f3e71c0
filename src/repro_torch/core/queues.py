"""Fixed-capacity FIFO task queues (port of ``repro.core.queues``).

A queue is ``(data, count)``: ``data`` is a ``(T, cap, width)`` int32
tensor whose first ``count[t]`` rows of tile ``t`` are live, in FIFO order
and compacted to the front.  Every function here is batched over the
leading tile axis T (the port's form of the reference's per-tile vmap).

All queues store int32; float payloads are bitcast with :func:`f2i` /
:func:`i2f`, so one dtype flows through the network buffers (the paper's
32-bit flits).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.mem import alloc


class Queue(NamedTuple):
    data: torch.Tensor  # (T, cap, width) int32
    count: torch.Tensor  # (T,) int32


def f2i(x: torch.Tensor) -> torch.Tensor:
    """Bitcast float32 -> int32 (a 32-bit flit)."""
    return x.to(torch.float32).view(torch.int32)


def i2f(x: torch.Tensor) -> torch.Tensor:
    """Bitcast int32 -> float32."""
    return x.view(torch.float32)


def queue_make(T: int, cap: int, width: int, space: str = "vmem",
               label: str = "queue", device="cuda") -> Queue:
    """T empty queues, allocated in their declared memory space."""
    data = alloc(space, "queue", (T, cap, width), torch.int32, label=label,
                 device=device)
    return Queue(data, torch.zeros((T,), dtype=torch.int32, device=device))


def queue_free(q: Queue) -> torch.Tensor:
    """Free rows of each tile's queue: capacity less count."""
    return q.data.shape[-2] - q.count


def queue_clear(q: Queue) -> Queue:
    """An emptied queue of the same shape, its storage zeroed, so that a
    cleared queue is bit-equal to a freshly made one (the serving front
    end resets a recycled lane's queues with it)."""
    return Queue(torch.zeros_like(q.data), torch.zeros_like(q.count))


def queue_push(q: Queue, rows: torch.Tensor,
               mask: torch.Tensor) -> tuple[Queue, torch.Tensor]:
    """Append ``rows[mask]`` (row order kept) at each tile's queue tail.

    Rows beyond capacity are dropped and counted.  Returns
    ``(new_queue, n_dropped (T,) int32)``.
    """
    T, cap, w = q.data.shape
    mi = mask.to(torch.int32)
    # target slot of each masked row: count + exclusive prefix count
    offs = q.count[:, None] + torch.cumsum(mi, dim=1, dtype=torch.int32) - mi
    ok = mask & (offs < cap)
    # Scatter into the flat buffer plus one trash row at its very end
    # (only dropped rows collide there); the queue is the contiguous prefix.
    size = T * cap * w
    tile = torch.arange(T, dtype=torch.int64, device=rows.device)[:, None]
    row = torch.where(ok, tile * cap + offs, T * cap)
    col = torch.arange(w, dtype=torch.int64, device=rows.device)
    flat = torch.empty(size + w, dtype=torch.int32, device=rows.device)
    flat[:size] = q.data.reshape(-1)
    flat.scatter_(0, (row[:, :, None] * w + col).reshape(-1),
                  rows.reshape(-1))
    n_push = ok.sum(dim=1, dtype=torch.int32)
    n_drop = mi.sum(dim=1, dtype=torch.int32) - n_push
    return Queue(flat[:size].view(T, cap, w), q.count + n_push), n_drop


def queue_take_front(q: Queue, n: torch.Tensor,
                     max_n: int) -> tuple[torch.Tensor, torch.Tensor, Queue]:
    """Pop the first ``min(n, count)`` entries of each tile (FIFO).

    Returns ``(taken (T, min(max_n, cap), w), taken_valid, q')``.  The
    reference pops with two order-keeping argsort partitions; since the
    taken slots are always a prefix, those permutations have a closed
    form, computed here directly: the taken buffer is the queue's head,
    and the kept buffer is the live rows ``[n, count)`` followed by the
    popped rows and then the dead tail — the same rows, bit for bit.
    """
    T, cap, w = q.data.shape
    ar = torch.arange(cap, dtype=torch.int32, device=q.data.device)[None]
    n = torch.minimum(n, q.count)[:, None]
    live = (q.count[:, None] - n)
    src = torch.where(ar < live, ar + n,
                      torch.where(ar < q.count[:, None], ar - live, ar))
    kept = torch.gather(q.data, 1, src.to(torch.int64)[:, :, None]
                        .expand(-1, -1, w))
    eff = min(max_n, cap)
    taken = q.data[:, :eff]
    taken_valid = ar[:, :eff] < n
    return taken, taken_valid, Queue(kept, live[:, 0])


def occurrence_index(dest: torch.Tensor, valid: torch.Tensor,
                     num_dest: int) -> torch.Tensor:
    """For each valid element, its 0-based rank among earlier valid
    elements with the same ``dest``; invalid elements get ``n``.

    (T, n) batched.  The group-start scan is ``torch.cummax`` (the
    reference's ``associative_scan(maximum)``); sort keys are int64 and
    unique, so sort stability does not matter.  The rows are sorted in one
    flat sort, each row's keys offset past the row before's: a sort along
    dim 1 of more than a few rows (serving lanes) falls to a segmented
    sort that is several times slower on the card.
    """
    T, n = dest.shape
    ar = torch.arange(n, dtype=torch.int64, device=dest.device)[None]
    d = torch.where(valid, dest, num_dest).to(torch.int64)  # invalid: trash
    rows = torch.arange(T, dtype=torch.int64, device=dest.device)[:, None]
    key = d * n + ar + rows * ((num_dest + 1) * n)  # row, group, then FIFO
    order = torch.argsort(key.reshape(-1)).view(T, n) - rows * n
    ds = torch.gather(d, 1, order)
    new_grp = torch.ones_like(ds, dtype=torch.bool)
    new_grp[:, 1:] = ds[:, 1:] != ds[:, :-1]
    grp_start = torch.cummax(torch.where(new_grp, ar, 0), dim=1).values
    occ_sorted = (ar - grp_start).to(torch.int32)
    occ = torch.empty_like(occ_sorted).scatter_(1, order, occ_sorted)
    return torch.where(valid, occ, n)


def histogram(dest: torch.Tensor, valid: torch.Tensor,
              num_dest: int) -> torch.Tensor:
    """(T, num_dest) int32 per-destination counts of valid elements."""
    T = dest.shape[0]
    idx = torch.where(valid, dest, num_dest - 1).to(torch.int64)
    out = torch.zeros((T, num_dest), dtype=torch.int32, device=dest.device)
    return out.scatter_add_(1, idx, valid.to(torch.int32))
