"""SSSP, WCC, SpMV, PageRank and BSP-mode BFS through the port == the JAX
package's, bit for bit.

As in ``tests/test_torch_engine.py``: one partition built by the JAX
package is carried across with ``partition_from_numpy``, and each workload
runs through the JAX package under ``backend="xla"`` and under
``backend="pallas", pallas_fuse=False`` (interpret mode), and through the
port on the CPU under ``"kernels"`` (the kernel wrappers' plain versions)
and ``"torch"``.  Values and every Stats field except ``launches`` must be
bitwise equal — for SpMV and PageRank that includes the float32 sums of
the add fold, which the port keeps in the reference's serial row order.
``launches`` on ``"kernels"`` equals the unfused Pallas run's, five per
round.  The results also match the port's own oracles.
"""
import numpy as np
import pytest

from repro.core import algorithms as ja
from repro.core.engine import EngineConfig as JConfig
from repro.core.graph import CSRGraph, rmat_edges
from repro_torch.core import algorithms as ta
from repro_torch.core import reference as tref
from repro_torch.core.engine import EngineConfig as TConfig
from repro_torch.core.graph import CSRGraph as TCSRGraph
from test_torch_engine import SMALL, TIGHT, assert_stats_equal, \
    port_partition

pytestmark = pytest.mark.torch_port

PR_ITERS = 8

# name: (app, rmat scale, T, knobs)
CASES = {
    "sssp-s7-T4-tight": ("sssp", 7, 4, TIGHT),
    "wcc-s7-T16-small": ("wcc", 7, 16, SMALL),
    "spmv-s8-T16-small": ("spmv", 8, 16, SMALL),
    "spmv-s7-T4-tight": ("spmv", 7, 4, TIGHT),
    "pagerank-s6-T4-small": ("pagerank", 6, 4, SMALL),
    "bfs_bsp-s7-T4-tight": ("bfs_bsp", 7, 4, TIGHT),
}


def graph(app, scale, T):
    n, src, dst, val = rmat_edges(scale, edge_factor=5, seed=scale + T)
    g = CSRGraph.from_edges(n, src, dst, val)
    return ja.symmetrize(g) if app == "wcc" else g


def run(pkg, app, pg, g, cfg):
    """The workload through one package's drivers; returns its Result."""
    root = int(np.argmax(g.ptr[1:] - g.ptr[:-1]))
    if app in ("sssp", "bfs_bsp"):
        fn = pkg.sssp if app == "sssp" else pkg.bfs
        return fn(pg, root, cfg)
    if app == "wcc":
        return pkg.wcc(pg, cfg)
    if app == "spmv":
        x = np.random.default_rng(1).normal(size=g.num_vertices) \
            .astype(np.float32)
        return pkg.spmv(pg, x, cfg)
    return pkg.pagerank(pg, iters=PR_ITERS, cfg=cfg)


def oracle(app, g):
    tg = TCSRGraph(g.ptr, g.dst, g.val)
    root = int(np.argmax(g.ptr[1:] - g.ptr[:-1]))
    if app == "sssp":
        return tref.sssp_ref(tg, root)
    if app == "bfs_bsp":
        return tref.bfs_ref(tg, root)
    if app == "wcc":
        return tref.wcc_ref(tg)
    if app == "spmv":
        x = np.random.default_rng(1).normal(size=g.num_vertices) \
            .astype(np.float32)
        return tref.spmv_ref(tg, x.astype(np.float64))
    return tref.pagerank_ref(tg, iters=PR_ITERS)


def check_oracle(app, got, want):
    if app in ("bfs_bsp", "wcc"):
        np.testing.assert_array_equal(got, want)
    elif app == "sssp":
        finite = np.isfinite(want)
        assert (np.isfinite(got) == finite).all()
        np.testing.assert_allclose(got[finite], want[finite], rtol=1e-5)
    elif app == "spmv":
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-4)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-7)


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_app_bitwise_equals_jax(case):
    app, scale, T, knobs = CASES[case]
    g = graph(app, scale, T)
    if app == "bfs_bsp":
        knobs = dict(knobs, mode="bsp")
    pg = ja.prepare(g, T=T)
    ref = {"xla": run(ja, app, pg, g, JConfig(backend="xla", **knobs)),
           "pallas-nofuse": run(ja, app, pg, g, JConfig(
               backend="pallas", pallas_fuse=False, **knobs))}
    tpg = port_partition(pg)
    port = {b: run(ta, app, tpg, g, TConfig(backend=b, **knobs))
            for b in ("kernels", "torch")}
    for rname, r in ref.items():
        for pname, p in port.items():
            where = f"{app}: port {pname} vs jax {rname}"
            np.testing.assert_array_equal(r.values, p.values, err_msg=where)
            assert_stats_equal(r.stats, p.stats, where)
            assert r.epochs == p.epochs, where
    st = port["kernels"].stats
    assert int(st.drops) == 0
    assert int(st.rounds) > 1
    assert int(st.launches) == 5 * int(st.rounds) == \
        int(ref["pallas-nofuse"].stats.launches)
    assert int(port["torch"].stats.launches) == 0
    if app == "bfs_bsp":
        assert int(st.epochs) >= 1
    if knobs.get("cap_route_range") == 2:  # spill/replay really ran
        assert int(st.spills.sum()) > 0
    check_oracle(app, port["kernels"].values, oracle(app, g))


def test_spmv_f32_bound_covers_float32_sums():
    """The float32 error limit of the SpMV oracle holds for numpy's serial
    float32 sum on a graph with hubs, and is tight enough to catch one
    update of median size lost or doubled at the largest hub, and a big
    one lost at a vertex of small in-degree."""
    n, src, dst, val = rmat_edges(10, edge_factor=16, seed=3)
    g = TCSRGraph.from_edges(n, src, dst, val)
    x = np.random.default_rng(0).normal(size=n).astype(np.float32)
    want = tref.spmv_ref(g, x.astype(np.float64))
    bound = tref.spmv_f32_bound(g, x.astype(np.float64))
    srcs = np.repeat(np.arange(n), g.ptr[1:] - g.ptr[:-1])
    prod = g.val * x[srcs]
    y32 = np.zeros(n, np.float32)
    np.add.at(y32, g.dst, prod)
    assert (np.abs(y32 - want) <= bound).all()
    indeg = np.bincount(g.dst, minlength=n)
    hub = int(np.argmax(indeg))
    assert indeg[hub] > 300
    t = np.sort(np.abs(prod[g.dst == hub]))[indeg[hub] // 2]
    for planted in (y32[hub] - t, y32[hub] + t):  # lost, doubled
        assert abs(planted - want[hub]) > bound[hub]
    e = int(np.argmax(np.abs(prod) * (indeg[g.dst] < 50)))  # big, few in
    lost = y32.copy()
    lost[g.dst[e]] -= prod[e]
    assert np.abs(lost - want)[g.dst[e]] > bound[g.dst[e]]
