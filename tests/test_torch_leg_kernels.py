"""Fused leg 0 and the close leg, as redesigned for the card.

Leg 0 runs over a grid (T, G + 1): G blocks a tile move the range queue's
old live rows while one more takes the frontier and pops, and the turned
queue holds its live rows only.  The close leg runs over a grid (T, G + 1):
G blocks a tile search their rows and count each slot's valid rows and
hits, the tile's last one folds the counts into ``acc``, one more block
appends the close spills in place (``kernels/engine/csrc/fused_legs.cu``).

This file imports no JAX, so the card's machine runs it:
``python -m pytest -q -m cuda tests/test_torch_leg_kernels.py``.
Anywhere: the wrappers' grids, the in-place append and the live-row turn,
with the launch recorded instead of made.  On the card (``cuda``): both
kernels held bitwise against their plain stages by the legs' contract
(``fused.contract``) inside engine runs (the reference's fused-leg sweep,
``tests/test_fused_leg.py``: ragged tails, an empty frontier, every app;
then full range queues, cap-0 queues and a close queue that overflows, on
captured operands; and the timed shapes, triangles on R-MAT-14 and BFS on
R-MAT-22 over 64 tiles), and the close leg at the special ``acc`` bases of
``tests/test_torch_close_fold.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import algorithms as alg
from repro_torch.core.engine import EngineConfig
from repro_torch.core.graph import CSRGraph, rmat_edges
from repro_torch.core.queues import Queue
from repro_torch.kernels.engine import fused
from repro_torch.kernels.engine.kernel import column_split
from test_torch_staging import (BOOL, CHAIN, CLASSIC, H100_SMS, LegCheck,
                                assert_same, card, check_call, launched,
                                launches, messages, shard, state,
                                template)
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

# one base a slot: -0, +0, the smallest subnormal, 2^24 - 1, 2^24, +inf,
# NaN, a fraction (whose + 1 steps round)
BASES = np.array([-0.0, 0.0, np.finfo(np.float32).smallest_subnormal,
                  2.0 ** 24 - 1, 2.0 ** 24, np.inf, np.nan, 0.1],
                 dtype=np.float32)


# --------------------------------------------------------------------------
# Anywhere: the grids, the in-place append, the live-row turn
# --------------------------------------------------------------------------

def test_close_leg_appends_in_place_over_a_grid(launches):  # noqa: F811
    """The close leg appends onto the close queue it is given (the
    returned state shares its storage), returns a new acc, and runs over
    (T, G + 1) with G the column split of its R rows, its slot counts and
    tickets in one scratch that the launch clears (its counts after them);
    it names one path at any R."""
    T, v_chunk = 64, 256
    for R in (64 * 64, 16448, 0):
        st = state(T, v_chunk, CHAIN)
        out = fused.fused_tri_leg4(template(fold="add"), None, None,
                                   shard(T, v_chunk, 4096), st,
                                   *messages(T, R, 2), *messages(T, 64, 2))
        fn, args = launched(launches, fused.LIBRARY)
        cq = st.queues[3]
        assert args[0] is cq.data
        assert out[0].queues[3].data is cq.data
        assert out[0].acc is not st.acc
        scratch = args[15]
        assert tuple(scratch.shape) == (2 * T * (v_chunk + 3),)
        assert args[10]._base is scratch  # the counts follow the slots
        assert args[-1] == column_split(T, R, H100_SMS).G
        assert fused.fused_tri_leg4.path == fused.CLOSE_PATH
    assert fused.IN_PLACE["fused_tri_leg4"] == 3
    assert column_split(T, 64 * 64, H100_SMS).G == 5


@pytest.mark.parametrize("leg", ["fused_leg0", "fused_tri_leg0"])
def test_leg0_turns_its_range_queue_over_a_grid(launches, leg):  # noqa: F811
    """Leg 0 turns the range queue into a new one (live rows) over (T, G +
    1): G = 1 for the main paths' queues (2,048 and 32,768 rows), one more
    block a LEG0_BLOCK_ROWS rows past them, at most the column split's;
    its popped message rows are the contract's (LIVE_TURN)."""
    T = 64
    queues = CLASSIC if leg == "fused_leg0" else CHAIN
    for cap, G in ((2048, 1), (32768, 1), (32769, 2), (262144, 5)):
        st = state(T, 65536, ((cap, 3),) + queues[1:])
        out = getattr(fused, leg)(
            template(payload="value" if leg == "fused_leg0" else "placed",
                     pops=tuple(32 for _ in queues)), None, None,
            shard(T, 65536, 4096), st)
        fn, args = launched(launches, fused.LIBRARY)
        ints = [a for a in args if isinstance(a, int)]
        assert ints[-2] == G, (cap, ints)
        assert out[0].queues[0].data is not st.queues[0].data
        assert out[1].shape == (T, 32, 3)
    assert column_split(T, 262144, H100_SMS).G == 5
    assert fused.LIVE_TURN[leg] == 0


def test_leg0_staging_holds_the_compacted_rows_only():
    """Leg 0's staging a tile: the popped slots and their compacted rows,
    the popped tasks and their remainder flags, each padded to 16 bytes."""
    assert fused.leg0_stage_bytes(32, 32) == 128 + 384 + 384 + 32
    assert fused.leg0_stage_bytes(32, 16384) == 128 + 384 + 196608 + 16384
    assert fused.leg0_stage_bytes(65536, 32) == 4 * 65536 + 12 * 65536 \
        + 384 + 32


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

def rmat(scale, ef, seed, sym=False):
    n, src, dst, val = rmat_edges(scale, edge_factor=ef, seed=seed)
    g = CSRGraph.from_edges(n, src, dst, val)
    return alg.symmetrize(g) if sym else g


SMALL = dict(f_pop=8, r_pop=8, u_pop=16, max_t2=8, cap_route_range=8,
             cap_route_update=32, cap_rangeq=128, cap_updq=4096)


def sweep_run(case, dev):
    """(run(cfg), knobs) of one case of the sweep."""
    g = rmat(6, 5, 1)
    root = int(np.argmax(g.ptr[1:] - g.ptr[:-1]))
    x = np.linspace(0.5, 1.5, g.num_vertices).astype(np.float32)
    gs = rmat(6, 5, 2, sym=True)
    leaf = CSRGraph.from_edges(8, np.array([0]), np.array([1]),
                               np.ones(1, np.float32))
    kind, T = case.rsplit("-T", 1)
    T = int(T)
    if kind == "bfs":
        pg = alg.prepare(g, T, device=dev)
        return (lambda c: alg.bfs(pg, root, c)), SMALL
    if kind == "bfs-static":
        pg = alg.prepare(g, T, device=dev)
        return (lambda c: alg.bfs(pg, root, c)), dict(SMALL,
                                                      policy="static")
    if kind == "bfs-empty":
        pg = alg.prepare(leaf, T, device=dev)
        return (lambda c: alg.bfs(pg, 7, c)), SMALL
    if kind == "spmv":
        pg = alg.prepare(g, T, device=dev)
        return (lambda c: alg.spmv(pg, x, c)), SMALL
    if kind == "pagerank":
        pg = alg.prepare(g, T, device=dev)
        return (lambda c: alg.pagerank(pg, iters=2, cfg=c)), SMALL
    if kind == "kcore2":
        pg = alg.prepare(gs, T, device=dev)
        return (lambda c: alg.kcore(pg, 2, c)), SMALL
    if kind == "triangles":
        pg = alg.prepare_triangles(gs, T, device=dev)
        return (lambda c: alg.triangles(pg, c)), SMALL
    if kind == "triangles-tight":
        pg = alg.prepare_triangles(rmat(8, 5, 2, sym=True), T, device=dev)
        return (lambda c: alg.triangles(pg, c)), dict(
            SMALL, cap_route_range=2, cap_route_update=4)
    raise ValueError(case)


SWEEP = ["bfs-T4", "bfs-T3", "bfs-static-T4", "bfs-empty-T4", "spmv-T4",
         "pagerank-T3", "kcore2-T4", "triangles-T4", "triangles-tight-T16"]


def with_queue(st, i, q):
    queues = list(st.queues)
    queues[i] = q
    return st._replace(queues=tuple(queues))


@pytest.mark.cuda
@pytest.mark.parametrize("case", SWEEP)
def test_leg0_and_close_leg_sweep_bitwise(monkeypatch, case):
    """Every fused-leg call of the run held against its plain stage (and a
    second call), the run's values and Stats bitwise equal to the "torch"
    backend's; then, on leg 0's first operands, a range queue one row from
    full and full (its old rows all live: the G blocks move nearly all of
    them), and on the close leg's, a cap-0 close queue and a close queue
    one slot from full, so that its spills drop."""
    dev = card()
    run, knobs = sweep_run(case, dev)
    cfg = EngineConfig(max_rounds=20000, **knobs)
    want = run(dataclasses.replace(cfg, backend="torch"))
    with LegCheck(monkeypatch) as chk:
        got = run(cfg)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.values, want.values)
    for f, a, b in zip(got.stats._fields, got.stats, want.stats):
        if f != "launches":
            assert torch.equal(a, b), (case, f)
    tri = case.startswith("triangles")
    assert chk.calls == (5 if tri else 3) * int(got.stats.rounds)
    leg0 = "fused_tri_leg0" if tri else "fused_leg0"
    real, tmpl, plain, ops = chk.first[leg0]
    st = ops[2]
    rq = st.queues[0]
    cap = rq.data.shape[1]
    for count in (cap - 1, cap):  # the G blocks move nearly every row
        full = Queue(rq.data, torch.full_like(rq.count, count))
        ops0 = (*ops[:2], with_queue(st, 0, full))
        check_call(leg0, real, tmpl, plain, ops0, real(tmpl, plain, *ops0))
    if not tri:
        return
    real, tmpl, plain, ops = chk.first["fused_tri_leg4"]
    st, spv = ops[2], ops[6]
    cq = st.queues[3]
    empty = Queue(cq.data[:, :0].contiguous(), torch.zeros_like(cq.count))
    cap = cq.data.shape[1]
    full = Queue(cq.data.clone(), torch.full_like(cq.count, cap - 1))
    spv = torch.ones_like(spv)  # every spill row valid: all but one drop
    for q, spills in ((empty, ops[6]), (full, spv)):
        ops4 = (*ops[:2], with_queue(st, 3, q), *ops[3:6], spills)
        got = real(tmpl, plain, *ops4)
        check_call("fused_tri_leg4", real, tmpl, plain, ops4, got)
        if q is full:
            assert bool((got[1] == spv.shape[1] - 1).all())


def special_close_operands(ops):
    """The close leg's operands ``ops`` with acc at the special bases (one
    a slot, in turn) and new delivered rows: on each tile, rows (v, w) of
    its vertices with an edge, w an edge of v's segment (a hit) or one
    past its last (a miss: segments are sorted), a tenth of them invalid,
    each slot of the bases with several of both."""
    me, sh, st, recv, rv, sp, spv = ops
    T, v_chunk = st.acc.shape
    e_chunk = sh.edge_dst.shape[1]
    rng = np.random.default_rng(5)
    ptr, deg = sh.ptr_start.cpu().numpy(), sh.deg.cpu().numpy()
    ed = sh.edge_dst.cpu().numpy()
    R = recv.shape[1]
    v = np.zeros((T, R), np.int32)
    w = np.zeros((T, R), np.int32)
    ok = rng.random((T, R)) < 0.9
    for t in range(T):
        slots = np.flatnonzero(deg[t] > 0)
        if not len(slots):
            ok[t] = False
            continue
        s = rng.choice(slots[:len(BASES)], R)
        lo = ptr[t, s] % e_chunk
        k = rng.integers(0, deg[t, s])
        hit = rng.random(R) < 0.5
        last = ed[t, lo + deg[t, s] - 1]
        w[t] = np.where(hit, ed[t, lo + k], last + 1)
        v[t] = t * v_chunk + s
    acc = np.resize(BASES, (T, v_chunk))
    dev = st.acc.device
    recv = torch.from_numpy(np.stack([v, w], -1)).to(dev)
    return (me, sh, st._replace(acc=torch.from_numpy(acc).to(dev)), recv,
            torch.from_numpy(ok).to(dev), sp, spv)


@pytest.mark.cuda
def test_close_leg_kernel_at_special_acc_bases(monkeypatch):
    """The close leg's kernel against its plain stage (no float atomic on
    either side) with acc at -0, +0, the smallest subnormal, 2^24 - 1,
    2^24, +inf, NaN and 0.1, each slot with hits and misses: bitwise by
    the legs' contract; the run's own rows too (R-MAT-8, T = 16)."""
    dev = card()
    run, knobs = sweep_run("triangles-tight-T16", dev)
    with LegCheck(monkeypatch) as chk:
        run(EngineConfig(max_rounds=200, **knobs))
    real, tmpl, plain, ops = chk.first["fused_tri_leg4"]
    ops = special_close_operands(ops)
    got = real(tmpl, plain, *ops)
    torch.cuda.synchronize()
    check_call("fused_tri_leg4", real, tmpl, plain, ops, got)
    acc = got[0].acc.cpu()
    assert int(got[2].sum()) > 0
    assert bool(acc.isnan().any()) and bool((acc == 2.0 ** 24).any())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["triangles-rmat14", "bfs-rmat22"])
def test_legs_at_the_timed_shapes_bitwise(monkeypatch, case):
    """Every fused-leg call of the first rounds at the shapes that
    chip_smoke.py times (64 tiles: triangles on symmetrized R-MAT-14,
    BFS on R-MAT-22 with the main path's update queue), held against its
    plain stage, a second call too."""
    dev = card()
    if case == "triangles-rmat14":
        pg = alg.prepare_triangles(rmat(14, 10, 1, sym=True), 64,
                                   device=dev)
        run, cfg = (lambda c: alg.triangles(pg, c)), EngineConfig(
            max_rounds=120)
    else:
        pg = alg.prepare(rmat(22, 10, 1), 64, "low_order", device=dev)
        run, cfg = (lambda c: alg.bfs(pg, 0, c)), EngineConfig(
            cap_updq=262144, max_rounds=120)
    with LegCheck(monkeypatch) as chk:
        run(cfg)
    torch.cuda.synchronize()
    names = {n for n, _ in chk.paths}
    assert ({"fused_tri_leg0", "fused_tri_leg4"} if case.startswith("tri")
            else {"fused_leg0"}) <= names
    assert chk.calls > 0
