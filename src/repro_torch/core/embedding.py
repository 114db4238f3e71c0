"""Embedding lookup (port of ``repro.core.embedding``, single device).

The reference's routed lookup (Dalorex placement of the vocab table over
the model axis, ids routed to their owner shard by one all_to_all) needs
a mesh; without one it is a plain gather of the placed table with
overflow 0 (``src/repro/core/embedding.py:84-88``, ``:120-125``), and that
is the port's path.  The routed lookup on a mesh waits for the SPMD item
(ROADMAP §1, item 5).
"""
from __future__ import annotations

import numpy as np
import torch


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


def routed_embed(table, ids, *, mesh=None, **kw):
    """Routed lookup.  With no mesh: ``table[ids]`` and overflow 0."""
    if mesh is not None:
        raise NotImplementedError(
            "routed_embed on a mesh: ROADMAP §1, item 5 (SPMD on "
            "torch.distributed)")
    return table[ids], torch.zeros((), dtype=torch.int32, device=ids.device)


def embed_lookup(table, ids, routed: bool, **kw):
    """Entry point used by the models: routed (Dalorex) or replicated."""
    if routed:
        return routed_embed(table, ids, **kw)
    return table[ids], torch.zeros((), dtype=torch.int32, device=ids.device)
