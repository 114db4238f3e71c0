"""The port's physical NoCs (``repro_torch.noc``) against the JAX
package's, bit for bit.

* Geometry units: ``line_usage`` on every wiring (mesh, torus, ruche,
  the segmented hier line with ``die`` in and out of ``(0, n)``, tile-led
  inputs), ``admit`` with and without a ``base``, ``line_link_classes``,
  ``tile_die_map``, ``grid_shape``, and every backend's ``link_classes``,
  ``pressure`` and ``pressure_limit``, on seeded random inputs.
* One ``route`` round of every backend on the same messages: received
  and spilled rows and every telemetry tensor.
* Engine runs: BFS on the mesh (T = 4), torus (T = 16) and ruche (T = 8,
  rows of 4 tiles, so the express channels carry flits) at ``link_cap=1``
  (the stress setting: heavy spill and replay) and SpMV (the add fold) on
  the torus at ``link_cap=2``, the port's ``"torch"`` and ``"kernels"``
  unfused and fused against ``backend="xla"``: values and every Stats
  field but ``launches`` bitwise, ``flits_per_link``,
  ``max_link_occupancy``, ``hop_histogram``, ``die_crossings``, ``cycles``
  and ``energy_pj`` included.  The hier fabric's runs are in
  ``tests/test_torch_hier.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import algorithms as ja
from repro.core.comm import LocalComm as JComm
from repro.core.engine import EngineConfig as JConfig
from repro.core.graph import CSRGraph, rmat_edges
from repro.noc import network as jnet
from repro.noc import topology as jtop
from repro_torch.core import algorithms as ta
from repro_torch.core import reference as tref
from repro_torch.core.comm import LocalComm as TComm
from repro_torch.core.engine import EngineConfig as TConfig
from repro_torch.core.graph import CSRGraph as TCSRGraph
from repro_torch.noc import network as tnet
from repro_torch.noc import topology as ttop
from test_torch_engine import assert_stats_equal, port_partition
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

# the knobs of tests/test_noc.py's small_cfg (T = 4), and its queue caps
# in tests/test_hier.py for T = 16
SMALL_NOC = dict(f_pop=8, r_pop=8, u_pop=16, max_t2=8, cap_route_range=8,
                 cap_route_update=32, cap_rangeq=128, cap_updq=2048,
                 max_rounds=20000)
SMALL_NOC16 = dict(SMALL_NOC, cap_rangeq=256, cap_updq=4096)
# the port's three paths: (backend, fuse)
PORT_PATHS = (("torch", False), ("kernels", False), ("kernels", True))


def t32(a):
    return torch.from_numpy(np.asarray(a, np.int32))


# --------------------------------------------------------------------------
# Geometry units.
# --------------------------------------------------------------------------

# (n, wrap, ruche, die): every branch of line_usage, with die in (0, n)
# (segmented) and out of it (the flat line)
LINES = {
    "mesh": (8, False, 0, 0), "mesh-odd": (7, False, 0, 0),
    "torus": (8, True, 0, 0), "torus-odd": (5, True, 0, 0),
    "ruche2": (8, False, 2, 0), "ruche3": (9, False, 3, 0),
    "ruche1-is-mesh": (6, False, 1, 0),
    "hier-mesh-2": (8, False, 0, 2), "hier-mesh-4": (8, False, 0, 4),
    "hier-torus-4": (8, True, 0, 4), "hier-torus-3": (9, True, 0, 3),
    "hier-die-n": (8, False, 0, 8), "hier-die-2n": (8, True, 0, 16),
}


@pytest.mark.parametrize("line", sorted(LINES))
def test_line_usage_matches_reference(line):
    n, wrap, ruche, die = LINES[line]
    rng = np.random.default_rng(n * 31 + ruche + die)
    a = rng.integers(0, n, 300)
    b = rng.integers(0, n, 300)
    jh, ju = jax.jit(jtop.line_usage, static_argnums=(2, 3, 4, 5))(
        jnp.asarray(a, jnp.int32), jnp.asarray(b, jnp.int32), n, wrap, ruche,
        die)
    th, tu = ttop.line_usage(t32(a), t32(b), n, wrap, ruche, die)
    assert th.dtype == torch.int32 and tu.dtype == torch.bool
    np.testing.assert_array_equal(np.asarray(jh), th.numpy())
    np.testing.assert_array_equal(np.asarray(ju), tu.numpy())
    np.testing.assert_array_equal(
        ttop.line_hops(t32(a), t32(b), n, wrap, ruche, die).numpy(),
        th.numpy())
    # tile-led: a leading T axis is carried through
    th2, tu2 = ttop.line_usage(t32(a.reshape(3, 100)), t32(b.reshape(3, 100)),
                               n, wrap, ruche, die)
    np.testing.assert_array_equal(th2.numpy().reshape(-1), th.numpy())
    np.testing.assert_array_equal(tu2.numpy().reshape(300, 4, n), tu.numpy())


@pytest.mark.parametrize("cap", [0, 1, 2, 5])
@pytest.mark.parametrize("with_base", [False, True])
def test_admit_matches_reference(cap, with_base):
    rng = np.random.default_rng(7 * cap + with_base)
    T, N, C, L = 3, 40, 4, 6
    use = rng.random((T, N, C, L)) < 0.15
    valid = rng.random((T, N)) < 0.7
    base = rng.integers(0, 3, (T, C, L)).astype(np.int32)
    got = ttop.admit(torch.from_numpy(use), torch.from_numpy(valid), cap,
                     t32(base) if with_base else None)
    jadmit = jax.jit(jtop.admit, static_argnums=2)
    for t in range(T):
        want = jadmit(jnp.asarray(use[t]), jnp.asarray(valid[t]), cap,
                      jnp.asarray(base[t]) if with_base else None)
        np.testing.assert_array_equal(np.asarray(want), got[t].numpy())
    if cap <= 0:  # the limit is off: valid itself comes back
        assert torch.equal(got, torch.from_numpy(valid))


@pytest.mark.parametrize("n,wrap,die", [(8, False, 0), (8, True, 0),
                                        (8, False, 4), (8, True, 2),
                                        (6, True, 3), (4, True, 4)])
def test_line_link_classes_match_reference(n, wrap, die):
    np.testing.assert_array_equal(jtop.line_link_classes(n, wrap, die),
                                  ttop.line_link_classes(n, wrap, die))


def test_tile_die_map_and_grid_shape_match_reference():
    for T, rows, ny, nx in ((16, 0, 2, 2), (64, 0, 2, 2), (16, 0, 2, 1),
                            (36, 0, 3, 3), (32, 4, 2, 4), (12, 3, 3, 2)):
        np.testing.assert_array_equal(jtop.tile_die_map(T, rows, ny, nx),
                                      ttop.tile_die_map(T, rows, ny, nx))
    with pytest.raises(ValueError):
        ttop.tile_die_map(16, 0, 3, 1)
    for T, rows in ((16, 0), (8, 0), (5, 0), (12, 3), (64, 0), (64, 2)):
        assert ttop.grid_shape(T, rows) == jtop.grid_shape(T, rows)
    with pytest.raises(ValueError):
        ttop.grid_shape(10, rows=4)


FABRICS = (  # name: (backend class, its extra fields)
    ("mesh", "Mesh2D", {}), ("torus", "Torus2D", {}),
    ("ruche", "Ruche", dict(ruche_factor=2)),
    ("ruche3", "Ruche", dict(ruche_factor=3)),
    ("hier", "Hier2D", dict(ndies_x=2, ndies_y=2)),
    ("hier-torus", "Hier2D", dict(ndies_x=2, ndies_y=1, base="torus")))
NETS = ("ideal",) + tuple(name for name, _, _ in FABRICS)


def nets(name, T=16, rows=4, cols=4, cap=2):
    """The reference's and the port's backend ``name``."""
    if name == "ideal":
        return jnet.IdealAllToAll(T), tnet.IdealAllToAll(T)
    cls, kw = {n: (c, k) for n, c, k in FABRICS}[name]
    return (getattr(jnet, cls)(T, rows, cols, cap, **kw),
            getattr(tnet, cls)(T, rows, cols, cap, **kw))


@pytest.mark.parametrize("name", NETS)
def test_backend_classes_and_pressure_match_reference(name):
    jn, tn = nets(name)
    for prop in ("num_links", "max_hops", "max_die_crossings"):
        assert getattr(tn, prop) == getattr(jn, prop), prop
    np.testing.assert_array_equal(np.asarray(jn.link_classes),
                                  tn.link_classes)
    cfg = TConfig()
    for caps in (None, (16, 64), (8, 8, 32, 32)):
        assert tn.pressure_limit(cfg, caps) == jn.pressure_limit(cfg, caps)
    flits = np.random.default_rng(5).integers(
        0, 50, (16, jn.num_links)).astype(np.int32)
    got = tn.pressure(torch.arange(16, dtype=torch.int32), t32(flits))
    assert got.dtype == torch.int32
    want = [int(jn.pressure(jnp.int32(t), jnp.asarray(flits[t])))
            for t in range(16)]
    assert got.tolist() == want


@pytest.mark.parametrize("name", NETS)
def test_route_round_matches_reference(name):
    """One route of every fabric on the same messages, some invalid, at
    one link per leg and two endpoint slots a destination: every output
    tensor bitwise, and the round conserves messages."""
    jn, tn = nets(name, 8, 2, 4, 1)
    T, n, chunk, capacity = 8, 24, 16, 2
    rng = np.random.default_rng(3)
    idx = rng.integers(0, T * chunk, (T, n)).astype(np.int32)
    msgs = np.stack([idx, idx * 7], axis=2)
    valid = rng.random((T, n)) < 0.8
    want = jax.jit(lambda m, v: jn.route(
        JComm(T), m, v, capacity, lambda x: x[..., 0] // chunk))(
            jnp.asarray(msgs), jnp.asarray(valid))
    got = tn.route(TComm(T), t32(msgs), torch.from_numpy(valid), capacity,
                   lambda m: m[..., 0] // chunk)
    for f in got._fields:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert w.shape == g.shape and w.dtype == g.dtype, (f, w.shape,
                                                          g.shape)
        np.testing.assert_array_equal(w, g, err_msg=f)
    assert int(got.recv_valid.sum() + got.spill_valid.sum()) == \
        int(valid.sum())
    if name != "ideal":  # the links were the bottleneck somewhere
        assert int(got.link_flits.sum(0).max()) <= 1


def test_make_network_selects_backend():
    T = 16
    assert isinstance(tnet.make_network(TConfig(noc="ideal"), T),
                      tnet.IdealAllToAll)
    net = tnet.make_network(TConfig(noc="torus", noc_rows=2), T)
    assert isinstance(net, tnet.Torus2D) and (net.rows, net.cols) == (2, 8)
    net = tnet.make_network(TConfig(noc="ruche", ruche_factor=3), T)
    assert isinstance(net, tnet.Ruche) and net.ruche == 3
    net = tnet.make_network(TConfig(noc="hier", ndies_x=2, ndies_y=2,
                                    hier_base="torus", link_cap=3), T)
    assert isinstance(net, tnet.Hier2D) and net.wrap and net.link_cap == 3
    assert (net.die_x, net.die_y, net.max_die_crossings) == (2, 2, 2)
    assert isinstance(tnet.make_network(TConfig(noc="mesh"), T), tnet.Mesh2D)
    with pytest.raises(ValueError):
        tnet.make_network(TConfig(noc="hypercube"), T)
    with pytest.raises(ValueError):
        tnet.make_network(TConfig(noc="hier", ndies_x=3), T)


# --------------------------------------------------------------------------
# Engine runs against the JAX package.
# --------------------------------------------------------------------------

def rmat(scale: int):
    n, src, dst, val = rmat_edges(scale, edge_factor=5, seed=0)
    return CSRGraph.from_edges(n, src, dst, val)


@pytest.fixture(scope="module")
def g():
    return rmat(7)


# The capped-link runs on 8 and 16 tiles take R-MAT-5 (32 vertices): at
# link_cap 1 or 2 both channels still spill and replay there (asserted),
# in 9-26 rounds instead of R-MAT-7's 50-125.
@pytest.fixture(scope="module")
def g5():
    return rmat(5)


def run_port_paths(run, cfg_kw, want, where):
    """Every port path of ``run(cfg)`` against the JAX result ``want``:
    values and Stats bitwise but ``launches``; returns the fused Stats."""
    for backend, fuse in PORT_PATHS:
        got = run(TConfig(backend=backend, fuse=fuse, **cfg_kw))
        w = f"{where} port {backend} fuse={fuse}"
        np.testing.assert_array_equal(want.values, got.values, err_msg=w)
        assert_stats_equal(want.stats, got.stats, w)
        assert int(got.stats.drops) == 0, w
    assert int(got.stats.launches) == 3 * int(got.stats.rounds)
    return got.stats


@pytest.mark.parametrize("noc,T", [("mesh", 4), ("torus", 16),
                                   ("ruche", 8)])
def test_bfs_on_grid_fabrics_bitwise_equals_jax(g, g5, noc, T):
    g = g if T == 4 else g5
    root = int(np.argmax(g.ptr[1:] - g.ptr[:-1]))
    jpg = ja.prepare(g, T=T)
    kw = dict(SMALL_NOC if T == 4 else SMALL_NOC16, noc=noc, link_cap=1)
    want = ja.bfs(jpg, root, JConfig(backend="xla", **kw))
    tpg = port_partition(jpg)
    st = run_port_paths(lambda c: ta.bfs(tpg, root, c), kw, want,
                        f"bfs {noc} T={T}")
    np.testing.assert_array_equal(
        want.values, tref.bfs_ref(TCSRGraph(g.ptr, g.dst, g.val), root))
    # link_cap=1 is the stress setting: both channels spill and replay
    assert (st.spills > 0).all() and int(st.max_link_occupancy) <= 2
    assert int(st.hop_histogram[1:].sum()) > 0
    if noc == "ruche":  # the express channels carried flits (4-tile rows)
        cls = tnet.make_network(TConfig(noc=noc), T).link_classes
        assert int(st.flits_per_link[torch.from_numpy(cls == 1)].sum()) > 0


def test_spmv_add_fold_on_torus_bitwise_equals_jax(g5):
    g = g5
    x = np.random.default_rng(1).normal(size=g.num_vertices) \
        .astype(np.float32)
    jpg = ja.prepare(g, T=16)
    kw = dict(SMALL_NOC16, noc="torus", link_cap=2)
    want = ja.spmv(jpg, x, JConfig(backend="xla", **kw))
    tpg = port_partition(jpg)
    st = run_port_paths(lambda c: ta.spmv(tpg, x, c), kw, want,
                        "spmv torus")
    assert (st.spills > 0).all()
