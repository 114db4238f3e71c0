"""The port's fused legs (``EngineConfig(fuse=True)``, the default) == the
JAX package's fused Pallas round, bit for bit, launches included.

Each case runs one workload on a partition built by the JAX package:
through the JAX package under ``backend="pallas"`` with
``pallas_fuse=True`` (interpret mode: one ``pallas_call`` per leg) and
under ``backend="xla"``, and through the port on the CPU under
``backend="kernels", fuse=True``, where each leg is one fused-leg wrapper
call running its plain version (the engine's stage under ``Ctx.fused``).
Values and every Stats field must be bitwise equal to the fused Pallas
run's — ``launches`` too: three per round for the classic programs and
k-core, five for the 4-channel triangles chain — and to the xla run's
but for ``launches``.  The tight knobs make every channel spill, so every
re-queue phase runs.  The port's defaults equal the reference's
``backend="pallas"`` defaults, fused included.
"""
import numpy as np
import pytest
import torch

from repro.core import algorithms as ja
from repro.core.engine import EngineConfig as JConfig
from repro.core.graph import CSRGraph, rmat_edges
from repro_torch.core import algorithms as ta
from repro_torch.core import reference as tref
from repro_torch.core.engine import EngineConfig as TConfig
from repro_torch.core.graph import CSRGraph as TCSRGraph
from repro_torch.kernels.engine import fused
from test_torch_apps import check_oracle, graph, oracle, run
from test_torch_engine import SMALL, TIGHT, assert_stats_equal, \
    port_partition
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port


def tensors(x):
    """The tensors of a (nested) tuple of stage outputs, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in tensors(y)]
    return []


def bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x

# name: (app, rmat scale, T, knobs)
CASES = {
    "bfs-s7-T4-tight": ("bfs", 7, 4, TIGHT),
    "bfs_bsp-s6-T4-tight": ("bfs_bsp", 6, 4, TIGHT),
    "bfs-s6-T4-static": ("bfs", 6, 4, dict(TIGHT, policy="static")),
    "sssp-s6-T4-tight": ("sssp", 6, 4, TIGHT),
    "wcc-s6-T16-small": ("wcc", 6, 16, SMALL),
    "spmv-s7-T4-tight": ("spmv", 7, 4, TIGHT),
    "pagerank-s6-T4-small": ("pagerank", 6, 4, SMALL),
}


def assert_all_stats_equal(ref, got, where):
    """Every Stats field, ``launches`` included."""
    assert_stats_equal(ref, got, where)
    assert int(ref.launches) == int(got.launches), (where, "launches")


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_port_bitwise_equals_jax_fused(case):
    app, scale, T, knobs = CASES[case]
    g = graph(app, scale, T)
    if app == "bfs_bsp":
        knobs = dict(knobs, mode="bsp")
    pg = ja.prepare(g, T=T)
    jf = run(ja, app, pg, g, JConfig(backend="pallas", **knobs))
    jx = run(ja, app, pg, g, JConfig(backend="xla", **knobs))
    tf = run(ta, app, port_partition(pg), g,
             TConfig(backend="kernels", fuse=True, **knobs))
    for rname, r in (("pallas fused", jf), ("xla", jx)):
        where = f"{app}: port fused vs jax {rname}"
        np.testing.assert_array_equal(r.values, tf.values, err_msg=where)
        assert_stats_equal(r.stats, tf.stats, where)
        assert r.epochs == tf.epochs, where
    assert_all_stats_equal(jf.stats, tf.stats, f"{app} fused")
    st = tf.stats
    assert int(st.launches) == 3 * int(st.rounds)
    assert int(st.drops) == 0 and int(st.rounds) > 1
    if knobs.get("cap_route_range") == 2:  # both re-queue phases ran
        assert int(st.spills[0]) > 0 and int(st.spills[1]) > 0
    check_oracle(app, tf.values, oracle(app, g))


def test_fused_port_from_a_root_without_out_edges():
    """An empty frontier after the first pop: the fused legs drain at
    once, as the reference's do."""
    g = CSRGraph.from_edges(8, np.array([0]), np.array([1]),
                            np.ones(1, np.float32))
    pg = ja.prepare(g, T=4)
    jf = ja.bfs(pg, 7, JConfig(backend="pallas", **SMALL))
    tf = ta.bfs(port_partition(pg), 7, TConfig(fuse=True, **SMALL))
    np.testing.assert_array_equal(jf.values, tf.values)
    assert_all_stats_equal(jf.stats, tf.stats, "empty frontier")
    assert int(tf.stats.launches) == 3 * int(tf.stats.rounds)


def test_fused_round_calls_no_unfused_wrapper(monkeypatch, gs):
    """Under ``fuse=True`` each leg is one fused-leg wrapper call: none of
    the unfused wrappers runs, for the classic program, k-core and
    triangles, and on the CPU no CUDA launch is counted."""
    from repro_torch.core import engine, program

    def refuse(*a, **k):
        raise AssertionError("an unfused kernel wrapper ran in a fused leg")

    for mod, name in ((program, "frontier_pop"), (program, "edge_scan_gather"),
                      (program, "edge_scan_stream"),
                      (program, "fold_scatter"), (engine, "queue_push_pop")):
        monkeypatch.setattr(mod, name, refuse)
    n, src, dst, val = rmat_edges(6, edge_factor=5, seed=5)
    g = CSRGraph.from_edges(n, src, dst, val)
    tpg = port_partition(ja.prepare(g, T=4))
    before = [k.launches for k in fused.KERNELS]
    for space in ("vmem", "hbm"):
        res = ta.bfs(tpg, 0, TConfig(fuse=True, edge_space=space, **SMALL))
        assert int(res.stats.launches) == 3 * int(res.stats.rounds) > 3
        res = ta.kcore(port_partition(ja.prepare(gs, T=4)), 5,
                       TConfig(edge_space=space, **SMALL))
        assert int(res.stats.launches) == 3 * int(res.stats.rounds) > 3
    res = ta.triangles(port_partition(ja.prepare_triangles(gs, T=4)),
                       TConfig(**SMALL))
    assert int(res.stats.launches) == 5 * int(res.stats.rounds) > 5
    assert [k.launches for k in fused.KERNELS] == before
    with pytest.raises(AssertionError, match="unfused"):
        ta.bfs(tpg, 0, TConfig(fuse=False, **SMALL))


@pytest.fixture(scope="module")
def gs():
    # the reference program tests' graph (tests/test_programs.py):
    # non-trivial cores for k = 2 and 5, and 235 triangles
    n, src, dst, val = rmat_edges(6, edge_factor=5, seed=2)
    return ja.symmetrize(CSRGraph.from_edges(n, src, dst, val))


def run_program(pkg, program, pg, cfg):
    if program.startswith("kcore"):
        return pkg.kcore(pg, int(program[5:]), cfg)
    return pkg.triangles(pg, cfg)


# name: (program, T, knobs); TIGHT spills on every channel of triangles
PROGRAM_CASES = {
    "kcore2-async": ("kcore2", 4, TIGHT),
    "kcore5-async": ("kcore5", 4, TIGHT),
    "kcore2-bsp": ("kcore2", 4, dict(TIGHT, mode="bsp")),
    "kcore5-bsp": ("kcore5", 4, dict(TIGHT, mode="bsp")),
    "kcore5-hbm": ("kcore5", 4, dict(SMALL, edge_space="hbm")),
    "triangles-T4": ("triangles", 4, TIGHT),
    "triangles-T16": ("triangles", 16, TIGHT),
}


@pytest.mark.parametrize("case", sorted(PROGRAM_CASES))
def test_fused_programs_bitwise_equal_jax_fused(gs, case):
    """k-core (3 legs: the classic leg 0 and 1 kernels with k-core's codes,
    then its threshold fold) and triangles (5 legs over 4 channels)."""
    program, T, knobs = PROGRAM_CASES[case]
    tri = program == "triangles"
    pg = ja.prepare_triangles(gs, T=T) if tri else ja.prepare(gs, T=T)
    jf = run_program(ja, program, pg, JConfig(backend="pallas", **knobs))
    jx = run_program(ja, program, pg, JConfig(backend="xla", **knobs))
    tf = run_program(ta, program, port_partition(pg), TConfig(**knobs))
    for rname, r in (("pallas fused", jf), ("xla", jx)):
        where = f"{case}: port fused vs jax {rname}"
        np.testing.assert_array_equal(r.values, tf.values, err_msg=where)
        assert_stats_equal(r.stats, tf.stats, where)
    assert_all_stats_equal(jf.stats, tf.stats, f"{case} fused")
    st = tf.stats
    assert int(st.launches) == (5 if tri else 3) * int(st.rounds)
    assert int(st.drops) == 0 and int(st.rounds) > 1
    tg = TCSRGraph(gs.ptr, gs.dst, gs.val)
    if tri:
        assert bool((st.spills > 0).all()), st.spills  # every re-queue ran
        want = tref.triangles_ref(tg, key=pg.place)
        assert int(want.sum()) == 235
    else:
        want = tref.kcore_ref(tg, int(program[5:]))
        assert 0 < int(want.sum()) < gs.num_vertices  # a non-trivial core
    np.testing.assert_array_equal(tf.values, want)
    if knobs.get("edge_space") == "hbm":
        assert int(st.hbm_windows) > 0


@pytest.mark.parametrize("program", ["kcore2", "triangles"])
def test_torch_backend_fuses_nothing(gs, program):
    """``fuse=True`` on the "torch" backend launches nothing, as the
    reference's xla backend."""
    pg = ja.prepare_triangles(gs, T=4) if program == "triangles" \
        else ja.prepare(gs, T=4)
    res = run_program(ta, program, port_partition(pg),
                      TConfig(fuse=True, backend="torch", **SMALL))
    assert int(res.stats.launches) == 0 < int(res.stats.rounds)


@pytest.mark.parametrize("program", ["bfs", "kcore5", "triangles"])
def test_default_config_equals_jax_pallas_default(gs, program):
    """``EngineConfig()`` with no arguments runs what the reference's
    ``EngineConfig(backend="pallas")`` runs: fused legs, the same values
    and every Stats field, ``launches`` included."""
    assert TConfig().fuse is True and JConfig(backend="pallas").pallas_fuse
    if program == "bfs":
        n, src, dst, val = rmat_edges(8, edge_factor=5, seed=12)
        g = CSRGraph.from_edges(n, src, dst, val)
        pg = ja.prepare(g, T=4)
        root = int(np.argmax(g.ptr[1:] - g.ptr[:-1]))
        jr = ja.bfs(pg, root, JConfig(backend="pallas"))
        tr = ta.bfs(port_partition(pg), root, TConfig())
    else:
        pg = ja.prepare_triangles(gs, T=4) if program == "triangles" \
            else ja.prepare(gs, T=4)
        jr = run_program(ja, program, pg, JConfig(backend="pallas"))
        tr = run_program(ta, program, port_partition(pg), TConfig())
    np.testing.assert_array_equal(jr.values, tr.values)
    assert_all_stats_equal(jr.stats, tr.stats, f"{program} defaults")
    per_round = 5 if program == "triangles" else 3
    assert int(tr.stats.launches) == per_round * int(tr.stats.rounds) > 0


# --------------------------------------------------------------------------
# Leg 2 appends in place on the card: the idempotence its checks rely on
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def twin_graph():
    # chip_smoke.py's twin phase: R-MAT-10, edge factor 10, seed 1
    n, src, dst, val = rmat_edges(10, edge_factor=10, seed=1)
    return CSRGraph.from_edges(n, src, dst, val)


def tri_graph():
    """Symmetrized R-MAT-8 (edge factor 5, seed 2): under the tight knobs
    over 16 tiles, triangles spill on all four channels in 292 rounds."""
    n, src, dst, val = rmat_edges(8, edge_factor=5, seed=2)
    return ja.symmetrize(CSRGraph.from_edges(n, src, dst, val))


def write_appended(q_in, q_out):
    """Write the rows that ``q_out`` appended after ``q_in``'s count into
    ``q_in``'s own buffer, as the leg-2 kernel appends in place."""
    for t, (c0, c1) in enumerate(zip(q_in.count.tolist(),
                                     q_out.count.tolist())):
        q_in.data[t, c0:c1] = q_out.data[t, c0:c1]


# app, or app:wrapper for the legs other than leg 2 that append in place:
# leg 1 onto the range queue (and triangles' leg 3 onto the range2 queue),
# the wedge leg onto the wedge queue, the close leg onto the close queue
IN_PLACE_CASES = ["bfs", "bfs_bsp", "spmv", "kcore5", "sssp:fused_leg1",
                  "kcore5:fused_leg1", "triangles:fused_tri_leg1",
                  "triangles:fused_tri_leg2", "triangles:fused_tri_leg3",
                  "triangles:fused_tri_leg4"]


@pytest.mark.parametrize("app", IN_PLACE_CASES)
def test_leg2_stage_appending_in_place_is_idempotent(monkeypatch,
                                                     twin_graph, app):
    """At every call with spills of a leg that appends in place (leg 2 by
    default; leg 1, the triangles legs 1 and 3, the wedge leg and the
    close leg where the case names them) in a fused run on the twin's
    R-MAT-10 over 16 tiles (triangles: symmetrized R-MAT-8; the tight
    knobs), the plain stage's appended rows, written into its
    input queue as the kernel writes them, make that queue the stage's own
    output queue, don't-care slots included; the stage run again on the
    same operands gives every output of the first run, bitwise
    (chip_smoke.py's checks re-run the leg after the kernel); and the run,
    carried on in the queue appended in place, still equals the JAX
    package's, values and every Stats field but launches."""
    from repro_torch.core.queues import Queue
    app, _, name = app.partition(":")
    tri = app == "triangles"
    g = ja.symmetrize(twin_graph) if app == "kcore5" else twin_graph
    if tri:  # R-MAT-10 runs 4,000 tight rounds of triangles: R-MAT-8
        g = tri_graph()
    T = 16
    pg = ja.prepare_triangles(g, T=T) if tri else ja.prepare(g, T=T)
    name = name or ("fused_kcore_leg2" if app == "kcore5" else "fused_leg2")
    qi = fused.IN_PLACE[name]
    real = getattr(fused, name)
    spilled = []

    def in_place(tmpl, plain, *ops):
        st = ops[2]
        first = real(tmpl, plain, *ops)
        if not bool(ops[6].any()):
            return first
        spilled.append(1)
        q_in, q_out = st.queues[qi], first[0].queues[qi]
        write_appended(q_in, q_out)
        assert torch.equal(q_in.data, q_out.data)
        second = plain(*ops)
        for i, (a, b) in enumerate(zip(tensors(first), tensors(second))):
            assert torch.equal(bits(a), bits(b)), (name, i)
        queues = list(second[0].queues)
        queues[qi] = Queue(q_in.data, queues[qi].count)
        return (second[0]._replace(queues=tuple(queues)), *second[1:])

    monkeypatch.setattr(fused, name, in_place)
    knobs = dict(TIGHT)
    if app in ("kcore5", "triangles"):
        tf = run_program(ta, app, port_partition(pg), TConfig(**knobs))
        jx = run_program(ja, app, pg, JConfig(backend="xla", **knobs))
    else:
        if app == "bfs_bsp":
            knobs["mode"] = "bsp"
        tf = run(ta, app, port_partition(pg), g, TConfig(**knobs))
        jx = run(ja, app, pg, g, JConfig(backend="xla", **knobs))
    assert spilled, f"no {name} call spilled"
    np.testing.assert_array_equal(jx.values, tf.values)
    assert_stats_equal(jx.stats, tf.stats, f"{app} {name} in place")
    assert int(tf.stats.launches) == (5 if tri else 3) * int(tf.stats.rounds)
