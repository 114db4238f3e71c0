"""The port's multi-die NoC (``noc="hier"``) and die-local placement
against the JAX package's.

* Partitions: the ``*_dielocal`` schemes (which switch ``equal_edges`` to
  ``die_aligned``) and ``die_aligned`` under a flat scheme give the JAX
  partition's shards array for array, on 2x2 and 2x1 die arrays; one die
  is the flat layout.
* Engine runs: BFS on ``hier`` 2x2 (mesh base, ``low_order_dielocal``)
  and ``hier`` 2x1 (torus base) at ``link_cap=1``, the port's ``"torch"``
  and ``"kernels"`` unfused and fused against ``backend="xla"``: values
  and every Stats field but ``launches`` bitwise.
* Port only: the die-crossing telemetry of one route is exact, and on
  uncapped links die-local placement carries strictly fewer DIE-class
  flits than the flat scheme (the criterion of ``tests/test_hier.py``),
  with the crossing counts conserved.
"""
import numpy as np
import pytest
import torch

from repro.core import algorithms as ja
from repro.core.engine import EngineConfig as JConfig
from repro.core.graph import CSRGraph, rmat_edges
from repro_torch.core import algorithms as ta
from repro_torch.core import reference as tref
from repro_torch.core.comm import LocalComm
from repro_torch.core.engine import EngineConfig as TConfig, zero_stats
from repro_torch.core.graph import CSRGraph as TCSRGraph
from repro_torch.noc import Hier2D, make_network, tile_die_map
from repro_torch.core.program import BFS
from repro_torch.noc.topology import CLASS_DIE
from test_torch_engine import port_partition
from test_torch_noc import run_port_paths
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

# the knobs of tests/test_hier.py's small_cfg
SMALL_HIER = dict(f_pop=8, r_pop=8, u_pop=16, max_t2=8, cap_route_range=8,
                  cap_route_update=32, cap_rangeq=256, cap_updq=4096,
                  max_rounds=20000)


@pytest.fixture(scope="module")
def g():
    n, src, dst, val = rmat_edges(7, edge_factor=5, seed=0)
    return CSRGraph.from_edges(n, src, dst, val)


def root_of(g):
    return int(np.argmax(g.ptr[1:] - g.ptr[:-1]))


def tgraph(g):
    return TCSRGraph(g.ptr, g.dst, g.val)


# --------------------------------------------------------------------------
# Partitions.
# --------------------------------------------------------------------------

PARTITIONS = {
    # name: (scheme, edge_mode, dies)
    "low_order_dielocal-2x2": ("low_order_dielocal", "equal_edges", (2, 2)),
    "high_order_dielocal-2x2": ("high_order_dielocal", "equal_edges",
                                (2, 2)),
    "degree_interleave_dielocal-2x1": ("degree_interleave_dielocal",
                                       "equal_edges", (2, 1)),
    "low_order_dielocal-1x1": ("low_order_dielocal", "equal_edges", (1, 1)),
    "low_order-die_aligned-2x2": ("low_order", "die_aligned", (2, 2)),
    "low_order_dielocal-vertex_aligned": ("low_order_dielocal",
                                          "vertex_aligned", (2, 2)),
}


@pytest.mark.parametrize("name", sorted(PARTITIONS))
def test_dielocal_partitions_equal_jax(g, name):
    scheme, edge_mode, dies = PARTITIONS[name]
    jp = ja.prepare(g, 16, scheme=scheme, edge_mode=edge_mode, dies=dies)
    tp = ta.prepare(tgraph(g), 16, scheme=scheme, edge_mode=edge_mode,
                    dies=dies, device="cpu")
    assert tp.edge_mode == jp.edge_mode
    if scheme.endswith("_dielocal") and edge_mode == "equal_edges":
        assert tp.edge_mode == "die_aligned"
    assert (tp.v_chunk, tp.e_chunk) == (jp.v_chunk, jp.e_chunk)
    for f in ("ptr_start", "deg", "edge_dst", "edge_val"):
        got = getattr(tp, f)
        assert got.dtype in (torch.int32, torch.float32)
        np.testing.assert_array_equal(np.asarray(getattr(jp, f)),
                                      got.numpy(), err_msg=f)
    np.testing.assert_array_equal(jp.place, tp.place)
    np.testing.assert_array_equal(jp.inv, tp.inv)


def test_dielocal_one_die_layout_equals_flat(g):
    a = ta.prepare(tgraph(g), 16, device="cpu")
    b = ta.prepare(tgraph(g), 16, scheme="low_order_dielocal", dies=(1, 1),
                   device="cpu")
    np.testing.assert_array_equal(a.place, b.place)
    for f in ("ptr_start", "edge_dst"):
        np.testing.assert_array_equal(getattr(a, f).numpy(),
                                      getattr(b, f).numpy())


def test_die_aligned_needs_a_die_map(g):
    with pytest.raises(ValueError, match="die_aligned"):
        ta.prepare(tgraph(g), 16, edge_mode="die_aligned", device="cpu")
    with pytest.raises(ValueError, match="needs tile_die"):
        ta.prepare(tgraph(g), 16, scheme="low_order_dielocal", device="cpu")


# --------------------------------------------------------------------------
# Engine runs against the JAX package.
# --------------------------------------------------------------------------

HIER_RUNS = {
    # name: (R-MAT scale, tiles, placement, dies of the placement,
    # EngineConfig fields).  The graphs are the smallest at which, at
    # link_cap 1, both channels still spill and replay and messages cross
    # dies (asserted): R-MAT-6 on 8 tiles (2 x 2 dies of 1 x 2) for the
    # die-local run, R-MAT-5 on 16 for the torus base (79 and 19 rounds;
    # R-MAT-7 on 16 tiles took 110 and 125)
    "2x2-mesh-dielocal": (6, 8, "low_order_dielocal", (2, 2),
                          dict(noc="hier", ndies_y=2, ndies_x=2)),
    "2x1-torus": (5, 16, "low_order", None,
                  dict(noc="hier", ndies_y=2, ndies_x=1,
                       hier_base="torus")),
}


@pytest.mark.parametrize("name", sorted(HIER_RUNS))
def test_hier_bfs_bitwise_equals_jax(name):
    scale, T, scheme, dies, fabric = HIER_RUNS[name]
    n, src, dst, val = rmat_edges(scale, edge_factor=5, seed=0)
    g = CSRGraph.from_edges(n, src, dst, val)
    root = root_of(g)
    jpg = ja.prepare(g, T, scheme=scheme, dies=dies)
    kw = dict(SMALL_HIER, link_cap=1, **fabric)
    want = ja.bfs(jpg, root, JConfig(backend="xla", **kw))
    tpg = port_partition(jpg)
    st = run_port_paths(lambda c: ta.bfs(tpg, root, c), kw, want,
                        f"bfs hier {name}")
    np.testing.assert_array_equal(want.values,
                                  tref.bfs_ref(tgraph(g), root))
    assert int(st.die_crossings[1:].sum()) > 0  # traffic crossed dies
    assert (st.spills > 0).all()


# --------------------------------------------------------------------------
# Die-crossing telemetry and the die-local criterion (port only).
# --------------------------------------------------------------------------

def test_die_crossing_counts_deterministic():
    """4x4 grid, 2x2 dies, uncapped links, ample endpoint slots: tile 0
    sends to itself, to tile 3 (one X boundary), 12 (one Y) and 15 (X and
    Y), so the die histogram and the DIE-class flits are exact."""
    net = Hier2D(16, 4, 4, link_cap=0, ndies_x=2, ndies_y=2)
    chunk = 4
    msgs = torch.full((16, 4, 2), -1, dtype=torch.int32)
    for j, d in enumerate((0, 3, 12, 15)):
        msgs[0, j] = torch.tensor([d * chunk, 7])
    r = net.route(LocalComm(16), msgs, msgs[..., 0] >= 0, 4,
                  lambda m: m[..., 0] // chunk)
    assert int(r.recv_valid.sum()) == 4 and int(r.spill_valid.sum()) == 0
    assert r.die_hist.sum(0).tolist() == [1, 2, 1]
    flits = r.link_flits.sum(0).numpy()
    assert flits[net.link_classes == CLASS_DIE].sum() == 4
    hop = r.hop_hist.sum(0).numpy()
    assert flits.sum() == (hop * np.arange(len(hop))).sum()


def test_zero_stats_carries_die_hist_shape():
    z = zero_stats(TConfig(noc="hier", ndies_x=2, ndies_y=2), 16, BFS,
                   "cpu")
    assert tuple(z.die_crossings.shape) == (3,)
    z1 = zero_stats(TConfig(noc="mesh"), 16, BFS, "cpu")
    assert tuple(z1.die_crossings.shape) == (1,)


def test_dielocal_strictly_reduces_die_flits(g):
    """At 2x2 dies on uncapped links, die-local placement carries strictly
    fewer DIE-class flits, and a smaller share of injections crosses a
    die, than the flat scheme on the same fabric; both reach the oracle
    with no drops, and the crossings are conserved: DIE-class flits ==
    sum k * die_hist[k], die_hist.sum() == hop_hist.sum()."""
    root = root_of(g)
    cfg = TConfig(noc="hier", ndies_x=2, ndies_y=2, link_cap=0,
                  **SMALL_HIER)
    net = make_network(cfg, 16)
    want = tref.bfs_ref(tgraph(g), root)
    runs = {s: ta.bfs(ta.prepare(tgraph(g), 16, scheme=s, dies=(2, 2),
                                 device="cpu"), root, cfg)
            for s in ("low_order", "low_order_dielocal")}
    die, frac = {}, {}
    for s, res in runs.items():
        np.testing.assert_array_equal(res.values, want)
        st = res.stats
        assert int(st.drops) == 0
        flits = st.flits_per_link.numpy().astype(np.int64)
        dh = st.die_crossings.numpy().astype(np.int64)
        hh = st.hop_histogram.numpy().astype(np.int64)
        die[s] = flits[net.link_classes == CLASS_DIE].sum()
        assert die[s] == (dh * np.arange(len(dh))).sum()
        assert dh.sum() == hh.sum()
        assert flits.sum() == (hh * np.arange(len(hh))).sum()
        frac[s] = dh[1:].sum() / dh.sum()
    assert die["low_order_dielocal"] < die["low_order"], die
    assert frac["low_order_dielocal"] < frac["low_order"], frac
    assert tile_die_map(16, 0, 2, 2).tolist() == \
        [0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3]

