"""The close fold's add does not depend on the order of its rows.

The triangles program's close fold (``close_fold``, the handler of the
close channel, ``src/repro/core/program.py:731-743``) adds ``found`` into
``acc`` at each valid row's slot, in row order: its addends are 0.0 (a
valid miss) and 1.0 (a hit) only.  Under round-to-nearest ``x + 1`` and
``x + 0`` commute (``x + 1`` is never -0, and ``x + 0`` changes only -0,
to +0), and ``x + 0`` twice is ``x + 0`` once, so any order of the rows
gives the same bits, even where ``x + 1`` no longer counts (2^24) and on
inf and NaN.  The fused close leg's kernel relies on that: it counts each
slot's valid rows and hits and adds them once
(``kernels/engine/csrc/fused_legs.cu``, ``fused_close_leg_kernel``).

Here the port's plain close fold runs on rows in their order and on a
seeded permutation of them, at acc bases -0.0, +0.0, the smallest
subnormal, 2^24 - 1, 2^24, +inf, NaN and a fraction, each slot with
several hits and misses, and invalid rows (the trash slot) among them:
the two runs are bitwise equal.  The port's plain fold is also held
against the JAX package's ``close_fold`` (through its ``scatter_fold(...,
"add")``) on the same inputs.  The card's twin, the kernel against the
plain stage at these bases, is ``tests/test_torch_leg_kernels.py``.
"""
import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import program as jp
from repro.core.engine import EngineConfig as JConfig
from repro.core.engine import GraphShard as JShard
from repro_torch.core import program as tp
from repro_torch.core.engine import EngineConfig as TConfig
from repro_torch.core.engine import GraphShard
from test_torch_leg_kernels import BASES
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

SUBNORMAL_SLOT = 2
V_CHUNK = len(BASES)
DEG = 6          # the sorted segment of each slot
E_CHUNK = V_CHUNK * DEG

State = collections.namedtuple("State", "acc")


def close_inputs(seed, T=2, R=160):
    """T tiles of V_CHUNK slots, each slot's sorted segment of DEG even
    placed ids, and R delivered (v, w) rows a tile: each slot gets rows
    whose w is in its segment (hits) and rows whose w is odd (misses), and
    about a tenth of the rows are invalid."""
    rng = np.random.default_rng(seed)
    ptr = np.tile(np.arange(V_CHUNK, dtype=np.int32) * DEG, (T, 1))
    ptr += np.arange(T, dtype=np.int32)[:, None] * E_CHUNK  # global index
    deg = np.full((T, V_CHUNK), DEG, np.int32)
    seg = np.sort(rng.choice(500, (T, V_CHUNK, DEG), replace=False)
                  .astype(np.int32) * 2, axis=-1)  # even ids
    edge_dst = seg.reshape(T, E_CHUNK)
    slot = rng.integers(0, V_CHUNK, (T, R))
    me = np.arange(T, dtype=np.int32)[:, None]
    v = (me * V_CHUNK + slot).astype(np.int32)  # placed ids of the tile
    hit = rng.random((T, R)) < 0.5
    pick = rng.integers(0, DEG, (T, R))
    w = np.where(hit, seg[me, slot, pick],
                 2 * rng.integers(0, 500, (T, R)) + 1).astype(np.int32)
    rv = rng.random((T, R)) < 0.9
    recv = np.stack([v, w], axis=-1)
    acc = np.tile(BASES, (T, 1))
    return dict(ptr_start=ptr, deg=deg, edge_dst=edge_dst, recv=recv, rv=rv,
                acc=acc)


def permuted(x, seed):
    """The same rows, each tile's in a seeded order."""
    rng = np.random.default_rng(seed + 1000)
    perm = np.stack([rng.permutation(x["rv"].shape[1])
                     for _ in range(x["rv"].shape[0])])
    rows = np.arange(x["rv"].shape[0])[:, None]
    return dict(x, recv=x["recv"][rows, perm], rv=x["rv"][rows, perm])


def port_close_fold(x):
    """The port's plain close fold (the fused close leg's plain stage
    runs it after its re-queue): (acc bits, found)."""
    T = x["acc"].shape[0]
    ctx = tp.Ctx(TConfig(), T, E_CHUNK, V_CHUNK, backend="kernels",
                 fused=True)
    sh = GraphShard(*(torch.from_numpy(x[k]) for k in
                      ("ptr_start", "deg", "edge_dst")),
                    torch.ones((T, E_CHUNK), dtype=torch.float32))
    me = torch.arange(T, dtype=torch.int32)
    st, _, _, found = tp.TRIANGLES.channels[3].handler(
        ctx, me, sh, State(torch.from_numpy(x["acc"])),
        torch.from_numpy(x["recv"]), torch.from_numpy(x["rv"]))
    return st.acc.numpy().view(np.int32), found.numpy()


def jax_close_fold(x):
    """The JAX package's close_fold, tile by tile (the engine vmaps it)."""
    T = x["acc"].shape[0]
    ctx = jp.Ctx(JConfig(), T, E_CHUNK, V_CHUNK)
    acc, found = [], []
    for t in range(T):
        sh = (jnp.asarray(x["ptr_start"][t]), jnp.asarray(x["deg"][t]),
              jnp.asarray(x["edge_dst"][t]), jnp.ones(E_CHUNK, jnp.float32))
        st, _, _, f = jp.TRIANGLES.channels[3].handler(
            ctx, jnp.int32(t), JShard(*sh), State(jnp.asarray(x["acc"][t])),
            jnp.asarray(x["recv"][t]), jnp.asarray(x["rv"][t]))
        acc.append(np.asarray(st.acc).view(np.int32))
        found.append(int(f))
    return np.stack(acc), np.array(found, np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_close_fold_bits_do_not_depend_on_row_order(seed):
    x = close_inputs(seed)
    acc, found = port_close_fold(x)
    acc_p, found_p = port_close_fold(permuted(x, seed))
    np.testing.assert_array_equal(acc, acc_p)
    np.testing.assert_array_equal(found, found_p)
    # every slot had hits and misses, so each base was folded
    rows = x["rv"][..., None] & (x["recv"][..., 0, None] % V_CHUNK
                                 == np.arange(V_CHUNK))
    assert rows.sum(axis=1).min() >= 4
    assert (acc != np.tile(BASES.view(np.int32), (2, 1))).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_port_close_fold_equals_jax_close_fold(seed):
    """Bitwise equal to the JAX package's close_fold, but at the smallest
    subnormal base, which XLA's CPU flushes to zero in its adds (as a TPU
    does) and the port keeps (as the card's kernels do): there the JAX
    run reads +0 and the port the subnormal or the count above it."""
    x = close_inputs(seed)
    acc, found = port_close_fold(x)
    acc_j, found_j = jax_close_fold(x)
    np.testing.assert_array_equal(found, found_j)
    keep = np.ones(V_CHUNK, bool)
    keep[SUBNORMAL_SLOT] = False
    np.testing.assert_array_equal(acc[:, keep], acc_j[:, keep])
    sub = acc[:, SUBNORMAL_SLOT].view(np.float32)
    sub_j = acc_j[:, SUBNORMAL_SLOT].view(np.float32)
    # a slot with hits counts them either way
    np.testing.assert_array_equal(np.where(sub >= 1, sub, 0), sub_j)
