"""One BFS query through the port == the JAX package's, bit for bit.

The same partition (built by the JAX package, carried across with
``partition_from_numpy``) runs through ``repro_torch.core.algorithms.bfs``
on the CPU under both port backends — ``"kernels"`` unfused
(``fuse=False``: the kernel wrappers, here their plain versions) and
``"torch"`` (inline ops) — and through
``repro.core.algorithms.bfs`` under ``backend="xla"`` and under
``backend="pallas", pallas_fuse=False`` (interpret mode).  Values and every
Stats field except ``launches`` must be bitwise equal, including the
float32 ``cycles`` / ``energy_pj`` model totals; ``launches`` counts five
kernel calls per round on "kernels" and on the unfused Pallas path, and
none on "torch".
"""
import numpy as np
import pytest

from repro.core import algorithms as ja
from repro.core.engine import EngineConfig as JConfig
from repro.core.graph import CSRGraph, rmat_edges
from repro.core.reference import bfs_ref
from repro_torch.core import algorithms as ta
from repro_torch.core.engine import EngineConfig as TConfig
from repro_torch.core.graph import partition_from_numpy

pytestmark = pytest.mark.torch_port

SMALL = dict(f_pop=8, r_pop=8, u_pop=16, max_t2=8, cap_route_range=8,
             cap_route_update=32, cap_rangeq=128, cap_updq=4096,
             max_rounds=20000)
# tight channel queues: most messages spill and replay
TIGHT = dict(SMALL, cap_route_range=2, cap_route_update=4)

CASES = {
    # name: (rmat scale, T, knobs)
    "s6-T4-small": (6, 4, SMALL),
    "s8-T16-small": (8, 16, SMALL),
    "s7-T4-tight": (7, 4, TIGHT),
    "s8-T16-tight": (8, 16, TIGHT),
    "s8-T4-defaults": (8, 4, {}),
    "s7-T4-static": (7, 4, dict(TIGHT, policy="static")),
}


def port_partition(pg):
    return partition_from_numpy(
        np.asarray(pg.ptr_start), np.asarray(pg.deg),
        np.asarray(pg.edge_dst), np.asarray(pg.edge_val), pg.place, pg.inv,
        pg.num_vertices, pg.num_edges, edge_mode=pg.edge_mode,
        sorted_adj=pg.sorted_adj, device="cpu")


def assert_stats_equal(ref, got, where):
    for f, a, b in zip(ref._fields, ref, got):
        if f == "launches":
            continue
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, (where, f)
        np.testing.assert_array_equal(
            a.view(np.int32) if a.dtype == np.float32 else a,
            b.view(np.int32) if b.dtype == np.float32 else b,
            err_msg=f"Stats.{f} differs ({where})")


def run_all(g, T, knobs, root):
    pg = ja.prepare(g, T=T)
    ref = {"xla": ja.bfs(pg, root, JConfig(backend="xla", **knobs)),
           "pallas-nofuse": ja.bfs(pg, root, JConfig(
               backend="pallas", pallas_fuse=False, **knobs))}
    tpg = port_partition(pg)
    port = {b: ta.bfs(tpg, root, TConfig(backend=b, fuse=False, **knobs))
            for b in ("kernels", "torch")}
    return ref, port


def check(g, ref, port, root):
    oracle = bfs_ref(g, root)
    rounds = int(ref["xla"].stats.rounds)
    for rname, r in ref.items():
        for pname, p in port.items():
            where = f"port {pname} vs jax {rname}"
            np.testing.assert_array_equal(r.values, p.values, err_msg=where)
            assert_stats_equal(r.stats, p.stats, where)
    for p in port.values():
        np.testing.assert_array_equal(p.values, oracle)
        assert int(p.stats.drops) == 0
    assert int(port["kernels"].stats.launches) == 5 * rounds == \
        int(ref["pallas-nofuse"].stats.launches)
    assert int(port["torch"].stats.launches) == 0
    return rounds


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_bfs_bitwise_equals_jax(case):
    scale, T, knobs = CASES[case]
    n, src, dst, val = rmat_edges(scale, edge_factor=5, seed=scale + T)
    g = CSRGraph.from_edges(n, src, dst, val)
    root = int(np.argmax(g.ptr[1:] - g.ptr[:-1]))
    ref, port = run_all(g, T, knobs, root)
    rounds = check(g, ref, port, root)
    assert rounds > 1
    if knobs.get("cap_route_range") == 2:  # spill/replay really ran
        assert int(port["kernels"].stats.spills.sum()) > 0


def test_port_bfs_from_a_root_without_out_edges():
    """A root with no out-edges drains at once on every backend."""
    g = CSRGraph.from_edges(8, np.array([0]), np.array([1]),
                            np.ones(1, np.float32))
    ref, port = run_all(g, 4, SMALL, 7)
    check(g, ref, port, 7)


def test_unported_options_raise():
    """``adapt`` is still to port and raises; the physical NoC and the
    trace, once refused, run and equal the JAX package's result."""
    g = CSRGraph.from_edges(8, np.array([0]), np.array([1]),
                            np.ones(1, np.float32))
    jpg = ja.prepare(g, T=4)
    tpg = port_partition(jpg)
    with pytest.raises(NotImplementedError, match="'Placement'"):
        ta.bfs(tpg, 0, TConfig(**SMALL, adapt=True))
    ref = ja.bfs(jpg, 0, JConfig(backend="xla", noc="mesh", **SMALL))
    for kw in (dict(noc="mesh"), dict(noc="mesh", trace=True)):
        got = ta.bfs(tpg, 0, TConfig(**SMALL, **kw))
        np.testing.assert_array_equal(ref.values, got.values)
        assert_stats_equal(ref.stats, got.stats, str(kw))
        assert (got.trace is None) == ("trace" not in kw)
    # k-core has fused legs now: fuse=True (the default) runs, 3 a round
    gs = ja.symmetrize(g)
    res = ta.kcore(port_partition(ja.prepare(gs, T=4)), 2,
                   TConfig(**SMALL, fuse=True))
    assert int(res.stats.launches) == 3 * int(res.stats.rounds) > 0
    with pytest.raises(ValueError, match="mode"):
        ta.bfs(tpg, 0, TConfig(**SMALL, mode="epoch"))
