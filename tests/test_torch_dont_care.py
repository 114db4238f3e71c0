"""The don't-care elements of the fused legs: nothing reads them.

Leg 0 (its range queue's live-row turn), the scan legs and the wedge leg
(``kernels/engine/fused.py``) leave a turned queue's slots from its count
on unwritten, and write 0 into the popped message rows past the pop,
where their plain stages keep the reference's stale rows; the legs that
append in place (leg 1, leg 2, the wedge leg and the close leg) write
their spills after the count of a queue whose slots past it are the
previous leg's don't-care.  The reference's ``fifo_turn`` makes both
don't-care (``src/repro/kernels/engine/kernel.py:95-121``).  Here the
fused engine's plain stages run with every queue slot past its count and
every invalid message row poisoned after each leg, and every value and
Stats field must keep its bits: against the unpoisoned run, and against
the JAX package's run.

The unfused round's ``queue_push_pop`` kernel writes its turned queue
below the new count only ("rows at or beyond the live count are
unobservable garbage", ``src/repro/kernels/engine/kernel.py:424-427``);
the unfused engine runs the same way with the turned queue poisoned from
its count on after every ``queue_push_pop`` call.  The unfused T2 scans'
kernel writes ``nb`` and ``w`` only for the groups of lanes that hold a
live lane (the invalid lanes are "don't-cares masked by ``jvalid`` at
every consumer", ``src/repro/kernels/engine/kernel.py:175-176``); the
unfused engine runs with ``nb`` and ``w`` poisoned where ``jvalid`` is
false after every ``edge_scan_gather`` and ``edge_scan_stream`` call,
the shard resident and streamed.
"""
import numpy as np
import pytest
import torch

from repro.core import algorithms as ja
from repro.core.engine import EngineConfig as JConfig
from repro.core.graph import CSRGraph, rmat_edges
from repro_torch.core import algorithms as ta
from repro_torch.core import engine as tengine
from repro_torch.core import reference as tref
from repro_torch.core.engine import EngineConfig as TConfig
from repro_torch.core.graph import CSRGraph as TCSRGraph
from repro_torch.kernels.engine import fused
from test_torch_apps import run
from test_torch_engine import TIGHT, assert_stats_equal, port_partition
from test_torch_fused_leg import (assert_all_stats_equal, run_program,
                                  tri_graph)
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

# poison words: a head flit far past every tile's range, and an empty one
POISON = (0x7F7FFFFF, -1)


def words(n, w):
    """n rows of w words, the two poison words row by row in turn."""
    even = torch.arange(n) % 2 == 0
    return torch.where(even, POISON[0], POISON[1]).to(torch.int32)[
        :, None].expand(n, w)


def poison(out):
    """Overwrite, in place, what a fused leg's kernel may leave other than
    the plain stage does: every queue slot from its count on, and every
    invalid message row."""
    for q in out[0].queues:
        T, cap, w = q.data.shape
        dead = torch.arange(cap)[None] >= q.count[:, None]
        q.data.copy_(torch.where(dead[:, :, None], words(cap, w), q.data))
    if len(out) > 2 and out[1].dim() == 3:  # the messages of legs 0 .. K-1
        msgs, mvalid = out[1], out[2]
        n, w = msgs.shape[1:]
        msgs.copy_(torch.where(mvalid[:, :, None], msgs, words(n, w)))


def test_poison_reaches_every_dont_care_element():
    """The poison covers exactly the queue slots from each count on and
    the invalid message rows, with both words."""
    T, cap, n = 2, 6, 5
    q = torch.arange(T * cap * 2, dtype=torch.int32).reshape(T, cap, 2)
    count = torch.tensor([2, 5], dtype=torch.int32)
    from repro_torch.core.queues import Queue
    from repro_torch.core.engine import EngineState
    z = torch.zeros((T, 3))
    st = EngineState(z, z, z.bool(), z.bool(), (Queue(q.clone(), count),),
                     torch.zeros(T, dtype=torch.int32))
    msgs = torch.arange(T * n * 3, dtype=torch.int32).reshape(T, n, 3)
    mvalid = torch.tensor([[1, 0, 1, 0, 0], [0, 1, 1, 1, 1]]).bool()
    out = (st, msgs.clone(), mvalid)
    poison(out)
    qd = out[0].queues[0].data
    for t in range(T):
        c = int(count[t])
        assert torch.equal(qd[t, :c], q[t, :c])
        assert torch.equal(qd[t, c:], words(cap, 2)[c:])
    assert torch.equal(out[1][mvalid], msgs[mvalid])
    assert set(out[1][~mvalid].unique().tolist()) == set(POISON)


def poison_turn(out):
    """Overwrite, in place, what ``queue_push_pop``'s kernel leaves
    unwritten: the turned queue's slots from its new count on."""
    ndata, ncount = out[2], out[3]
    T, cap, w = ndata.shape
    dead = torch.arange(cap)[None] >= ncount[:, None]
    ndata.copy_(torch.where(dead[:, :, None], words(cap, w), ndata))


@pytest.mark.parametrize("w", [2, 3, 4])
def test_turn_poison_reaches_every_slot_past_the_count(w):
    """The poison of a turn covers exactly the slots of the turned queue
    from the new count on, with both words, full and empty tiles
    included, and leaves the other outputs alone."""
    from repro_torch.kernels.engine.kernel import fifo_turn
    rng = np.random.default_rng(w)
    T, cap, m, max_n = 4, 12, 6, 4
    data = torch.from_numpy(rng.integers(0, 99, (T, cap, w), dtype=np.int32))
    count = torch.tensor([0, cap, 5, 2], dtype=torch.int32)
    rows = torch.from_numpy(rng.integers(0, 99, (T, m, w), dtype=np.int32))
    valid = torch.from_numpy(rng.random((T, m)) < 0.5)
    n = torch.tensor([max_n, 0, 2, max_n], dtype=torch.int32)
    out = fifo_turn(data, count, rows, valid, n, max_n)
    clean = [a.clone() for a in out]
    poison_turn(out)
    for i in (0, 1, 3, 4):
        assert torch.equal(out[i], clean[i])
    for t in range(T):
        c = int(out[3][t])
        assert torch.equal(out[2][t, :c], clean[2][t, :c])
        assert torch.equal(out[2][t, c:], words(cap, w)[c:])
    assert int(out[3][1]) == cap             # full: no slot poisoned
    assert int(out[3][0]) < 2 < cap          # (nearly) empty: all poisoned


@pytest.fixture(scope="module")
def twin_graph():
    # chip_smoke.py's twin phase: R-MAT-10, edge factor 10, seed 1
    n, src, dst, val = rmat_edges(10, edge_factor=10, seed=1)
    return CSRGraph.from_edges(n, src, dst, val)


# app: knobs.  The defaults spill on both channels of the classic apps on
# the twin's R-MAT-10 in 9-72 rounds (the tight knobs take thousands);
# k-core needs the tight knobs for spills, and k = 2 spills on its range
# channel only.  "triangles" runs on the twin's R-MAT-10 with the defaults,
# spilling on all four channels (its 404 rounds take the JAX package three
# minutes on the CPU, so it is held to the unpoisoned run and the oracle);
# "triangles-rmat8" on symmetrized R-MAT-8 with the tight knobs, held to
# the JAX package too.
POISON_APPS = {"bfs": {}, "bfs_bsp": dict(mode="bsp"), "sssp": {}, "wcc": {},
               "spmv": {}, "pagerank": {}, "kcore2": TIGHT, "kcore5": TIGHT,
               "kcore5_bsp": dict(TIGHT, mode="bsp"), "triangles": {},
               "triangles-rmat8": TIGHT}


def workload(app, twin_graph):
    """An app of POISON_APPS on the twin's partition over 16 tiles:
    ``(program, graph, JAX partition, the port's, drive(package, cfg,
    partition))``."""
    prog = app.split("_")[0].split("-")[0]
    g = twin_graph
    if prog in ("kcore2", "kcore5", "triangles", "wcc"):
        g = ja.symmetrize(twin_graph)
    if app == "triangles-rmat8":
        g = tri_graph()
    T = 16
    pg = ja.prepare_triangles(g, T=T) if prog == "triangles" \
        else ja.prepare(g, T=T)
    root = int(np.argmax(g.ptr[1:] - g.ptr[:-1]))

    def drive(pkg, cfg, p):
        if prog.startswith("kcore") or prog == "triangles":
            return run_program(pkg, prog, p, cfg)
        if prog == "bfs":
            return pkg.bfs(p, root, cfg)
        return run(pkg, app, p, g, cfg)

    return prog, g, pg, port_partition(pg), drive


@pytest.mark.parametrize("app", sorted(POISON_APPS))
def test_poisoned_dont_care_slots_change_no_bit(monkeypatch, twin_graph,
                                                app):
    """The fused engine's plain stages over 16 tiles (the twin's R-MAT-10,
    the knobs of POISON_APPS), with every queue slot
    from its count on and every invalid message row poisoned after each
    leg, give the values and every Stats field of the unpoisoned run,
    launches included (three or five a round, as the JAX package's fused
    round), and of the JAX package's run but for launches.  So no consumer
    reads what the scan and wedge legs' kernels leave unwritten (a turned
    queue's slots past its count) or write as 0 (the popped message rows
    past the pop).  Every channel spills (k = 2: the range channel), so
    every re-queue reads a poisoned queue."""
    calls = []
    for k in fused.KERNELS:
        def hooked(tmpl, plain, *ops, real=k):
            out = real(tmpl, plain, *ops)
            poison(out)
            calls.append(1)
            return out
        monkeypatch.setattr(fused, k.__name__, hooked)
    knobs = POISON_APPS[app]
    prog, g, pg, tpg, drive = workload(app, twin_graph)
    poisoned = drive(ta, TConfig(**knobs), tpg)
    assert calls
    monkeypatch.undo()
    clean = drive(ta, TConfig(**knobs), tpg)
    np.testing.assert_array_equal(clean.values, poisoned.values)
    assert_all_stats_equal(clean.stats, poisoned.stats, f"{app} unpoisoned")
    if app == "triangles":
        tg = TCSRGraph(g.ptr, g.dst, g.val)
        np.testing.assert_array_equal(
            poisoned.values, tref.triangles_ref(tg, key=pg.place))
    else:
        jx = drive(ja, JConfig(backend="xla", **knobs), pg)
        np.testing.assert_array_equal(jx.values, poisoned.values)
        assert_stats_equal(jx.stats, poisoned.stats, f"{app} jax")
    st = poisoned.stats
    assert int(st.drops) == 0 and int(st.rounds) > 1
    assert int(st.launches) == (5 if prog == "triangles" else 3) * int(
        st.rounds)
    spilling = st.spills[:1] if app == "kcore2" else st.spills
    assert bool((spilling > 0).all()), st.spills  # every re-queue ran


# the unfused round (fuse=False: queue_push_pop once a channel and round)
UNFUSED_POISON_APPS = ("bfs", "bfs_bsp", "spmv", "pagerank", "kcore2",
                       "kcore5")


@pytest.mark.parametrize("app", UNFUSED_POISON_APPS)
def test_poisoned_turn_changes_no_bit_unfused(monkeypatch, twin_graph, app):
    """The unfused engine over 16 tiles (the twin's R-MAT-10, the knobs of
    POISON_APPS), with the turned queue of every ``queue_push_pop`` call
    poisoned from its new count on, gives the values and every Stats field
    of the unpoisoned run, launches included, and of the JAX package's
    run but for launches.  So no consumer reads the slots that the
    kernel leaves unwritten."""
    calls = []
    real = tengine.queue_push_pop

    def hooked(*ops):
        out = real(*ops)
        poison_turn(out)
        calls.append(1)
        return out

    monkeypatch.setattr(tengine, "queue_push_pop", hooked)
    knobs = dict(POISON_APPS[app], fuse=False)
    prog, g, pg, tpg, drive = workload(app, twin_graph)
    poisoned = drive(ta, TConfig(**knobs), tpg)
    assert len(calls) == 2 * int(poisoned.stats.rounds)
    monkeypatch.undo()
    clean = drive(ta, TConfig(**knobs), tpg)
    np.testing.assert_array_equal(clean.values, poisoned.values)
    assert_all_stats_equal(clean.stats, poisoned.stats, f"{app} unpoisoned")
    del knobs["fuse"]
    jx = drive(ja, JConfig(backend="xla", **knobs), pg)
    np.testing.assert_array_equal(jx.values, poisoned.values)
    assert_stats_equal(jx.stats, poisoned.stats, f"{app} jax")
    st = poisoned.stats
    assert int(st.drops) == 0 and int(st.rounds) > 1
    spilling = st.spills[:1] if app == "kcore2" else st.spills
    assert bool((spilling > 0).all()), st.spills  # every re-queue ran


def poison_scan(out):
    """Overwrite, in place, what the scans' kernel may leave unwritten:
    ``nb`` and ``w`` where ``jvalid`` is false (nb the two poison words
    lane by lane in turn, w a NaN and float32 max)."""
    nb, w, jvalid = out
    even = torch.arange(nb.shape[-1]) % 2 == 0
    nb.copy_(torch.where(jvalid, nb, torch.where(even, *POISON).to(
        torch.int32)))
    junk = torch.where(even, torch.tensor(float("nan")),
                       torch.tensor(float(np.finfo(np.float32).max)))
    w.copy_(torch.where(jvalid, w, junk))


def test_scan_poison_reaches_every_invalid_lane():
    """The poison of a scan covers exactly the lanes where jvalid is
    false, in nb and w, and leaves jvalid and the valid lanes alone."""
    from repro_torch.kernels.engine.kernel import segment_gather
    rng = np.random.default_rng(3)
    T, e_chunk, R, mt = 3, 40, 12, 6
    ed = torch.from_numpy(rng.integers(-1, 99, (T, e_chunk), dtype=np.int32))
    ev = torch.from_numpy(rng.random((T, e_chunk), dtype=np.float32))
    start = torch.from_numpy(rng.integers(0, T * e_chunk, (T, R),
                                          dtype=np.int32))
    stop = start + torch.from_numpy(rng.integers(0, mt + 1, (T, R),
                                                 dtype=np.int32))
    rv = torch.from_numpy(rng.random((T, R)) < 0.6)
    out = segment_gather(ed, ev, start, stop, rv, mt)
    clean = [a.clone() for a in out]
    poison_scan(out)
    jv = clean[2]
    assert 0 < int(jv.sum()) < jv.numel()
    assert torch.equal(out[2], jv)
    assert torch.equal(out[0][jv], clean[0][jv])
    assert torch.equal(out[1][jv].view(torch.int32),
                       clean[1][jv].view(torch.int32))
    assert set(out[0][~jv].unique().tolist()) == set(POISON)
    dead = out[1][~jv]
    assert bool(dead.isnan().any()) and not bool(dead.isfinite().all())


# the unfused apps whose scans read each kind of payload: BFS (none),
# SSSP (the weights), SpMV (value * weight), k-core (none, symmetrized)
SCAN_POISON_APPS = ("bfs", "sssp", "spmv", "kcore5")


@pytest.mark.parametrize("space", ["vmem", "hbm"])
@pytest.mark.parametrize("app", SCAN_POISON_APPS)
def test_poisoned_scan_lanes_change_no_bit_unfused(monkeypatch, twin_graph,
                                                   app, space):
    """The unfused engine over 16 tiles (the twin's R-MAT-10), the shard
    resident (edge_scan_gather) or streamed (edge_scan_stream), with nb
    and w poisoned where jvalid is false after every scan call, gives the
    values and every Stats field of the unpoisoned run, launches included,
    and of the JAX package's run but for launches.  So no consumer reads
    the lanes that the scans' kernel leaves unwritten."""
    from repro_torch.core import program as tprogram
    name = "edge_scan_stream" if space == "hbm" else "edge_scan_gather"
    calls = []
    real = getattr(tprogram, name)

    def hooked(*ops):
        out = real(*ops)
        poison_scan(out)
        calls.append(1)
        return out

    monkeypatch.setattr(tprogram, name, hooked)
    knobs = dict(POISON_APPS[app], fuse=False, edge_space=space)
    prog, g, pg, tpg, drive = workload(app, twin_graph)
    poisoned = drive(ta, TConfig(**knobs), tpg)
    assert len(calls) == int(poisoned.stats.rounds)
    monkeypatch.undo()
    clean = drive(ta, TConfig(**knobs), tpg)
    np.testing.assert_array_equal(clean.values, poisoned.values)
    assert_all_stats_equal(clean.stats, poisoned.stats, f"{app} unpoisoned")
    del knobs["fuse"]
    jx = drive(ja, JConfig(backend="xla", **knobs), pg)
    np.testing.assert_array_equal(jx.values, poisoned.values)
    assert_stats_equal(jx.stats, poisoned.stats, f"{app} jax")
    st = poisoned.stats
    assert int(st.drops) == 0 and int(st.rounds) > 1
    assert (int(st.hbm_windows) > 0) == (space == "hbm")
