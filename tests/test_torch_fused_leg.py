"""The port's fused legs (``EngineConfig(fuse=True)``) == the JAX package's
fused Pallas round, bit for bit, launches included.

Each case runs one classic workload on a partition built by the JAX
package: through the JAX package under ``backend="pallas"`` with
``pallas_fuse=True`` (interpret mode: one ``pallas_call`` per leg) and
under ``backend="xla"``, and through the port on the CPU under
``backend="kernels", fuse=True``, where each leg is one fused-leg wrapper
call running its plain version (the engine's stage under ``Ctx.fused``).
Values and every Stats field must be bitwise equal to the fused Pallas
run's — ``launches`` too, three per round — and to the xla run's but for
``launches``.  The tight knobs make both channels spill, so both re-queue
phases run.
"""
import numpy as np
import pytest

from repro.core import algorithms as ja
from repro.core.engine import EngineConfig as JConfig
from repro.core.graph import CSRGraph, rmat_edges
from repro_torch.core import algorithms as ta
from repro_torch.core.engine import EngineConfig as TConfig
from repro_torch.kernels.engine import fused
from test_torch_apps import check_oracle, graph, oracle, run
from test_torch_engine import SMALL, TIGHT, assert_stats_equal, \
    port_partition

pytestmark = pytest.mark.torch_port

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


def test_fused_round_calls_no_unfused_wrapper(monkeypatch):
    """Under ``fuse=True`` each leg is one fused-leg wrapper call: none of
    the unfused wrappers runs, and on the CPU no CUDA launch is counted."""
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
    assert [k.launches for k in fused.KERNELS] == before
    with pytest.raises(AssertionError, match="unfused"):
        ta.bfs(tpg, 0, TConfig(**SMALL))


@pytest.mark.parametrize("program", ["kcore", "triangles"])
def test_unported_fused_programs_raise(program):
    n, src, dst, val = rmat_edges(5, edge_factor=4, seed=2)
    gs = ja.symmetrize(CSRGraph.from_edges(n, src, dst, val))
    cfg = TConfig(fuse=True, **SMALL)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if program == "kcore":
            ta.kcore(port_partition(ja.prepare(gs, T=4)), 2, cfg)
        else:
            ta.triangles(port_partition(ja.prepare_triangles(gs, T=4)),
                         cfg)
    # the torch backend fuses nothing, as the reference's xla backend
    res = ta.kcore(port_partition(ja.prepare(gs, T=4)), 2,
                   TConfig(fuse=True, backend="torch", **SMALL))
    assert int(res.stats.launches) == 0
