"""The port's graph generation, partitioning and BFS oracle == the JAX
package's, on the same seeds."""
import numpy as np
import pytest

from repro.core import graph as jg
from repro.core import reference as jref
from repro_torch.core import graph as tg
from repro_torch.core import reference as tref
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module", params=[(6, 5), (8, 10)])
def graphs(request):
    scale, ef = request.param
    jn, js, jd, jv = jg.rmat_edges(scale, edge_factor=ef, seed=2)
    tn, ts, td, tv = tg.rmat_edges(scale, edge_factor=ef, seed=2)
    assert jn == tn
    for a, b in ((js, ts), (jd, td), (jv, tv)):
        np.testing.assert_array_equal(a, b)
    return (jg.CSRGraph.from_edges(jn, js, jd, jv),
            tg.CSRGraph.from_edges(tn, ts, td, tv))


def test_csr_graphs_equal(graphs):
    jgr, tgr = graphs
    for f in ("ptr", "dst", "val"):
        a, b = getattr(jgr, f), getattr(tgr, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("weights", ["uniform", "ones"])
@pytest.mark.parametrize("dedup", [True, False])
def test_csr_from_edges_equal(weights, dedup):
    """Both CSR builds and both weight streams, duplicate edges kept or
    dropped: the same arrays."""
    J = jg.rmat_edges(9, edge_factor=6, seed=4, weights=weights)
    P = tg.rmat_edges(9, edge_factor=6, seed=4, weights=weights)
    jgr = jg.CSRGraph.from_edges(*J, dedup=dedup)
    tgr = tg.CSRGraph.from_edges(*P, dedup=dedup)
    for f in ("ptr", "dst", "val"):
        a, b = getattr(jgr, f), getattr(tgr, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("scheme", ["low_order", "high_order",
                                    "degree_interleave"])
@pytest.mark.parametrize("edge_mode", ["equal_edges", "vertex_aligned"])
def test_partition_arrays_bitwise(graphs, scheme, edge_mode):
    jgr, tgr = graphs
    jp = jg.partition_graph(jgr, 4, scheme, edge_mode)
    tp = tg.partition_graph(tgr, 4, scheme, edge_mode, device="cpu")
    assert (tp.v_chunk, tp.e_chunk) == (jp.v_chunk, jp.e_chunk)
    for f in ("ptr_start", "deg", "edge_dst", "edge_val"):
        a, b = np.asarray(getattr(jp, f)), getattr(tp, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32),
                                      err_msg=f)
    np.testing.assert_array_equal(jp.place, tp.place)
    np.testing.assert_array_equal(jp.inv, tp.inv)
    assert (tp.num_vertices, tp.num_edges, tp.edge_mode) == \
        (jp.num_vertices, jp.num_edges, jp.edge_mode)


def test_partition_from_numpy_round_trips(graphs):
    jgr, tgr = graphs
    jp = jg.partition_graph(jgr, 16, "low_order")
    tp = tg.partition_from_numpy(
        np.asarray(jp.ptr_start), np.asarray(jp.deg),
        np.asarray(jp.edge_dst), np.asarray(jp.edge_val), jp.place, jp.inv,
        jp.num_vertices, jp.num_edges, device="cpu")
    own = tg.partition_graph(tgr, 16, "low_order", device="cpu")
    assert (tp.T, tp.v_chunk, tp.e_chunk) == (jp.T, jp.v_chunk, jp.e_chunk)
    for f in ("ptr_start", "deg", "edge_dst", "edge_val"):
        np.testing.assert_array_equal(np.asarray(getattr(jp, f)),
                                      getattr(tp, f).numpy(), err_msg=f)
        assert getattr(tp, f).dtype == getattr(own, f).dtype
        np.testing.assert_array_equal(getattr(own, f).numpy(),
                                      getattr(tp, f).numpy(), err_msg=f)


def test_unported_partitions_raise(graphs):
    """The multi-die partitions the port once refused (the die-local
    placement and the die-aligned edge mode) now equal the JAX package's
    array for array; without a die map both still refuse."""
    jgr, tgr = graphs
    for scheme, edge_mode in (("low_order_dielocal", "equal_edges"),
                              ("low_order", "die_aligned")):
        jp = jg.partition_graph(jgr, 4, scheme, edge_mode, dies=(2, 2))
        tp = tg.partition_graph(tgr, 4, scheme, edge_mode, dies=(2, 2),
                                device="cpu")
        assert tp.edge_mode == jp.edge_mode == "die_aligned"
        for f in ("ptr_start", "deg", "edge_dst", "edge_val"):
            np.testing.assert_array_equal(np.asarray(getattr(jp, f)),
                                          getattr(tp, f).numpy(), err_msg=f)
        np.testing.assert_array_equal(jp.place, tp.place)
        with pytest.raises(ValueError):
            tg.partition_graph(tgr, 4, scheme, edge_mode, device="cpu")


@pytest.mark.parametrize("scale", [6, 7, 8, 9])
def test_vectorized_bfs_ref_equals_loop_oracle(scale):
    n, s, d, v = jg.rmat_edges(scale, edge_factor=4, seed=scale)
    g = jg.CSRGraph.from_edges(n, s, d, v)
    deg = g.ptr[1:] - g.ptr[:-1]
    tgr = tg.CSRGraph(g.ptr, g.dst, g.val)
    for root in (int(np.argmax(deg)), int(np.flatnonzero(deg == 0)[0])):
        want = jref.bfs_ref(g, root)
        got = tref.bfs_ref(tgr, root)
        np.testing.assert_array_equal(want, got)
    assert np.isinf(got).any()  # unreachable vertices are covered
