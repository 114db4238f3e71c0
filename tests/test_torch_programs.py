"""k-core peeling and 2-hop triangle counting through the port == the JAX
package's, bit for bit, and the triangle partition's layout equal to the
reference's.

Each engine case runs the JAX package (``backend="xla"`` and unfused
``"pallas"`` in interpret mode) and the port on the CPU (``"kernels"`` with
``fuse=False``, and ``"torch"``) on one partition carried across with
``partition_from_numpy``: values and every Stats field except
``launches`` bitwise equal, and ``launches`` on ``"kernels"`` equal to the
unfused Pallas run's.  k-core runs in both async and BSP mode; triangles
is the 4-channel chain, whose second range channel turns the width-4
queue.
"""
import numpy as np
import pytest

from repro.core import algorithms as ja
from repro.core import program as jp
from repro.core.engine import EngineConfig as JConfig
from repro.core.graph import CSRGraph, rmat_edges
from repro_torch.core import algorithms as ta
from repro_torch.core import program as tp
from repro_torch.core import reference as tref
from repro_torch.core.engine import EngineConfig as TConfig
from repro_torch.core.graph import CSRGraph as TCSRGraph
from test_torch_engine import SMALL, TIGHT, assert_stats_equal, \
    port_partition
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module")
def gs():
    # the reference tests' graph (tests/test_programs.py): non-trivial
    # cores for k = 2 and 5, and 235 triangles
    n, src, dst, val = rmat_edges(6, edge_factor=5, seed=2)
    return ja.symmetrize(CSRGraph.from_edges(n, src, dst, val))


def tgraph(g):
    return TCSRGraph(g.ptr, g.dst, g.val)


def check_twins(ref, port, where):
    for rname, r in ref.items():
        for pname, p in port.items():
            w = f"{where}: port {pname} vs jax {rname}"
            np.testing.assert_array_equal(r.values, p.values, err_msg=w)
            assert_stats_equal(r.stats, p.stats, w)
    st = port["kernels"].stats
    assert int(st.drops) == 0
    assert int(st.launches) == int(ref["pallas-nofuse"].stats.launches) > 0
    assert int(port["torch"].stats.launches) == 0


@pytest.mark.parametrize("k", [2, 5])
@pytest.mark.parametrize("mode", ["async", "bsp"])
def test_port_kcore_bitwise_equals_jax(gs, k, mode):
    knobs = dict(TIGHT if mode == "async" else SMALL, mode=mode)
    pg = ja.prepare(gs, T=4)
    ref = {"xla": ja.kcore(pg, k, JConfig(backend="xla", **knobs)),
           "pallas-nofuse": ja.kcore(pg, k, JConfig(
               backend="pallas", pallas_fuse=False, **knobs))}
    tpg = port_partition(pg)
    port = {b: ta.kcore(tpg, k, TConfig(backend=b, fuse=False, **knobs))
            for b in ("kernels", "torch")}
    check_twins(ref, port, f"kcore{k} {mode}")
    st = port["kernels"].stats
    assert int(st.launches) == 5 * int(st.rounds)
    want = tref.kcore_ref(tgraph(gs), k)
    np.testing.assert_array_equal(port["kernels"].values, want)
    assert 0 < int(want.sum()) < gs.num_vertices  # a non-trivial core


@pytest.mark.parametrize("T,knobs", [(4, SMALL), (16, TIGHT)],
                         ids=["T4-small", "T16-tight"])
def test_port_triangles_bitwise_equals_jax(gs, T, knobs):
    pg = ja.prepare_triangles(gs, T=T)
    ref = {"xla": ja.triangles(pg, JConfig(backend="xla", **knobs)),
           "pallas-nofuse": ja.triangles(pg, JConfig(
               backend="pallas", pallas_fuse=False, **knobs))}
    tpg = port_partition(pg)
    port = {b: ta.triangles(tpg, TConfig(backend=b, fuse=False, **knobs))
            for b in ("kernels", "torch")}
    check_twins(ref, port, f"triangles T={T}")
    st = port["kernels"].stats
    assert tuple(st.msgs.shape) == (4,) and bool((st.msgs > 0).all())
    want = tref.triangles_ref(tgraph(gs), key=pg.place)
    np.testing.assert_array_equal(port["kernels"].values, want)
    assert int(want.sum()) == 235


@pytest.mark.parametrize("T,scheme", [(4, "low_order"), (16, "high_order")])
def test_prepare_triangles_layout_equals_jax(gs, T, scheme):
    """The port's vertex-aligned partition and its vectorized
    ``sort_adjacency`` give the reference's shards, element for element."""
    jpg = ja.prepare_triangles(gs, T=T, scheme=scheme)
    tpg = ta.prepare_triangles(tgraph(gs), T=T, scheme=scheme,
                               device="cpu")
    assert (tpg.edge_mode, tpg.sorted_adj) == ("vertex_aligned", True)
    for f in ("ptr_start", "deg", "edge_dst", "edge_val"):
        a, b = np.asarray(getattr(jpg, f)), getattr(tpg, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_array_equal(jpg.place, tpg.place)
    # sort_adjacency alone, on the reference's unsorted partition
    jpv = ja.prepare(gs, T=T, scheme=scheme, edge_mode="vertex_aligned")
    jpe = ja.sort_adjacency(jpv)
    tpe = ta.sort_adjacency(port_partition(jpv))
    assert tpe.sorted_adj
    for f in ("edge_dst", "edge_val"):
        np.testing.assert_array_equal(np.asarray(getattr(jpe, f)),
                                      getattr(tpe, f).numpy(), err_msg=f)


def test_triangles_reject_wrong_partition(gs):
    tpg = ta.prepare(tgraph(gs), T=4, device="cpu")
    with pytest.raises(ValueError, match="prepare_triangles"):
        ta.triangles(tpg, TConfig(**SMALL))
    tpv = ta.prepare(tgraph(gs), T=4, edge_mode="vertex_aligned",
                     device="cpu")
    with pytest.raises(ValueError, match="prepare_triangles"):
        ta.triangles(tpv, TConfig(**SMALL))


@pytest.mark.parametrize("prog", ["kcore2", "triangles"])
def test_sized_cfg_and_min_caps_match_jax(prog):
    jprog = jp.kcore_program(2) if prog == "kcore2" else jp.TRIANGLES
    tprog = tp.kcore_program(2) if prog == "kcore2" else tp.TRIANGLES
    knobs = dict(SMALL, cap_updq=16)
    for T in (4, 16):
        assert tprog.min_caps(TConfig(**knobs), T) == \
            jprog.min_caps(JConfig(**knobs), T)
        jc = jp.sized_cfg(JConfig(**knobs), jprog, T)
        tc = tp.sized_cfg(TConfig(**knobs), tprog, T)
        assert (tc.cap_rangeq, tc.cap_updq) == (jc.cap_rangeq, jc.cap_updq)
        tprog.validate(tc, T)
        with pytest.raises(ValueError, match="worst-case inflow"):
            tprog.validate(TConfig(**knobs), T)


@pytest.mark.parametrize("scale,keyed", [(6, False), (6, True), (9, True)])
def test_triangles_wedge_ref_equals_triangles_ref(scale, keyed,
                                                  monkeypatch):
    """The vectorized oracle counts what the loop oracle counts, per
    vertex, under an id order or a permuted one, with the wedges taken
    in one chunk and in many chunks of about 1,000."""
    n, src, dst, val = rmat_edges(scale, edge_factor=8, seed=scale)
    g = tgraph(ja.symmetrize(CSRGraph.from_edges(n, src, dst, val)))
    key = np.random.default_rng(scale).permutation(n) if keyed else None
    want = tref.triangles_ref(g, key)
    assert int(want.sum()) > 0
    for chunk in (1000, 1 << 23):
        monkeypatch.setattr(tref, "WEDGE_CHUNK", chunk)
        np.testing.assert_array_equal(tref.triangles_wedge_ref(g, key),
                                      want)
