"""The Dalorex embedding lookup: vocab-routed and data-local (port of
``repro.core.embedding``).

The paper's placement and routing applied to an LM embedding table: the
table is dealt over the mesh's ``model`` axis by the low-order bits of
the vocab id (``owner(v) = v mod M``, ``local(v) = v div M``), and token
ids are *routed to the data* by one all-to-all; the gathered rows ride a
second all-to-all back.  Per-destination slots have a static
``capacity``: a token that does not fit gets a zero row and is counted
(the overflow, summed over the model axis).  Without a mesh the lookup is
a plain gather of the placed table with overflow 0
(``src/repro/core/embedding.py:84-88``, ``:120-125``).

On a mesh each process holds what the reference's ``shard_map`` hands
its body: its model shard of the placed table (:func:`table_shard`) and
its block of the ids (:func:`ids_block`, the reference's ``in_specs``:
the batch dealt over the batch axes and the sequence over the model axis
where they divide).  It gets back its block of the result, ``(nb, sb,
d)``, as the reference's ``out_specs`` shard it like the ids, and the
overflow summed over the model axis; nothing is gathered.  Forward only:
the gradient through the lookup comes with the LM training path
(ROADMAP.md §1).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.comm import exchange_rows, mesh_axis
from repro_torch.core.queues import occurrence_index

I32 = torch.int32


def padded_vocab(vocab: int, shards: int) -> int:
    return ((vocab + shards - 1) // shards) * shards


def place_table(table_rows, num_shards: int):
    """Host helper: (V_pad, d) vocab-order -> placed order (chunked by owner).

    placed[(v % M) * chunk + v // M] = rows[v]."""
    v_pad = table_rows.shape[0]
    chunk = v_pad // num_shards
    ids = np.arange(v_pad)
    place = (ids % num_shards) * chunk + ids // num_shards
    out = np.empty_like(table_rows)
    out[place] = table_rows
    return out


def _routed_lookup_local(group, table_shard, ids, capacity: int, M: int):
    """One process's routed lookup: ``table_shard`` (V_pad / M, d), ``ids``
    (n,) of its block.  Returns (emb (n, d), overflow count)."""
    owner = ids % M                      # low-order placement = the route
    local_row = ids // M
    valid = ids >= 0
    occ = occurrence_index(owner[None], valid[None], M)[0]
    fits = valid & (occ < capacity)
    slot = torch.where(fits, owner * capacity + occ, M * capacity)
    # a send buffer of local row indices; -1 marks an empty slot, and the
    # last slot is the trash row of the ids that do not fit
    send = torch.full((M * capacity + 1,), -1, dtype=I32, device=ids.device)
    send.scatter_(0, slot.to(torch.int64), local_row.to(I32))
    got = exchange_rows(group, send[:-1])    # (M * capacity,)
    rvalid = got >= 0
    rows = table_shard[got.clamp(min=0).to(torch.int64)]
    rows = torch.where(rvalid[:, None], rows, torch.zeros_like(rows))
    back = exchange_rows(group, rows)        # (M * capacity, d)
    # the row for slot owner * capacity + occ comes back to that slot (the
    # all-to-all is an involution on the block layout)
    emb = back[slot.clamp(max=M * capacity - 1).to(torch.int64)]
    emb = torch.where(fits[:, None], emb, torch.zeros_like(emb))
    return emb, (valid & ~fits).sum(dtype=I32)


def _dealt(mesh, B: int, S: int, model_axis: str, batch_axes, seq_shard):
    """The reference's rule: ``(batch_axes, dp, seq_shard)`` with the
    shardings that do not divide dropped (e.g. batch 1 in decode)."""
    names = mesh.mesh_dim_names
    dp = 1
    for a in batch_axes:
        dp *= mesh.size(names.index(a))
    if B % dp != 0 or B < dp:
        batch_axes, dp = (), 1
    M = mesh.size(names.index(model_axis))
    if S % M != 0 or S < M:
        seq_shard = False
    return tuple(batch_axes), dp, seq_shard


def ids_block(ids, mesh, *, model_axis: str = "model",
              batch_axes=("data",), seq_shard: bool = True):
    """This process's block of the whole ``ids`` (B, S), on its device:
    the batch dealt over ``batch_axes`` (row-major) and the sequence over
    ``model_axis`` where they divide, the reference's ``in_specs``."""
    _, M, m, dev = mesh_axis(mesh, model_axis)
    B, S = ids.shape
    batch_axes, dp, seq_shard = _dealt(mesh, B, S, model_axis, batch_axes,
                                       seq_shard)
    nb, sb = B // dp, S // M if seq_shard else S
    bi = 0  # this process's batch block, row-major over the batch axes
    for a in batch_axes:
        bi = bi * mesh.size(mesh.mesh_dim_names.index(a)) \
            + mesh.get_local_rank(a)
    s0 = m * sb if seq_shard else 0
    return ids[bi * nb:(bi + 1) * nb, s0:s0 + sb].to(dev)


def table_shard(table, mesh, *, model_axis: str = "model"):
    """This process's model shard of the placed ``table`` (V_pad, d): its
    ``V_pad / M`` rows, on its device."""
    _, M, m, dev = mesh_axis(mesh, model_axis)
    chunk = table.shape[0] // M
    return table[m * chunk:(m + 1) * chunk].to(dev)


def routed_embed(table, ids, *, mesh=None, model_axis: str = "model",
                 batch_axes=("data",), seq_shard: bool = True,
                 capacity_factor: float = 2.0):
    """Routed lookup of ``ids`` in the placed ``table``.  With no mesh:
    ``table`` (V_pad, d), ``ids`` (B, S), returns ``table[ids]`` and
    overflow 0.  On a DeviceMesh: ``table`` is this process's model shard
    (:func:`table_shard`) and ``ids`` its block (nb, sb); returns this
    process's block ``(nb, sb, d)`` of the lookup over ``model_axis``, on
    its device, and the overflow summed over the model axis.  A
    destination takes ``max(1, int(nb * sb * capacity_factor) // M)`` ids
    of a block, as in the reference.  ``batch_axes`` and ``seq_shard`` are
    the reference's: they say how the whole ids were dealt
    (:func:`ids_block` takes them); the lookup reads the block alone."""
    if mesh is None:
        return table[ids], torch.zeros((), dtype=I32, device=ids.device)
    group, M, _, dev = mesh_axis(mesh, model_axis)
    capacity = max(1, int(ids.numel() * capacity_factor) // M)
    emb, ovf = _routed_lookup_local(group, table.to(dev),
                                    ids.to(dev).reshape(-1), capacity, M)
    dist.all_reduce(ovf, group=group)
    return emb.reshape(tuple(ids.shape) + (table.shape[1],)), ovf


def embed_lookup(table, ids, routed: bool, **kw):
    """Entry point used by the models: routed (Dalorex) or replicated."""
    if routed:
        return routed_embed(table, ids, **kw)
    return table[ids], torch.zeros((), dtype=torch.int32, device=ids.device)
