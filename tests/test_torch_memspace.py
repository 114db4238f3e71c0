"""The HBM-streamed edge shard (``edge_space="hbm"``) through the port ==
the JAX package's, bit for bit.

Kernel level: the port's plain ``segment_stream`` (and the
``edge_scan_stream`` wrapper, which runs it on CPU tensors) equals the JAX
package's ``segment_stream`` body and its ``edge_scan_stream`` Pallas
kernel (interpret mode) on every element, valid lanes and don't-care lanes
alike, over the sweep of ``tests/test_memspace.py`` (window multiples of
``max_t2``, a segment ending at the chunk border) and an empty frontier.

Engine level: hbm runs of the port equal the JAX package's hbm runs in
values and every Stats field — ``cycles``, ``energy_pj``, ``hbm_windows``
and ``hbm_edges`` included — unfused against ``xla`` and fused against
the fused Pallas round (``launches`` too); and a tile budget under the
resident footprint rejects ``edge_space="vmem"`` while ``"hbm"`` runs and
equals the unconstrained resident run.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import algorithms as ja
from repro.core.engine import EngineConfig as JConfig
from repro.core.graph import CSRGraph, rmat_edges
from repro.kernels.engine import kernel as jk
from repro_torch.core import algorithms as ta
from repro_torch.core import reference as tref
from repro_torch.core.engine import EngineConfig as TConfig
from repro_torch.core.graph import CSRGraph as TCSRGraph
from repro_torch.core.program import BFS, as_program
from repro_torch.kernels.engine import edge_scan_stream, segment_stream, tally
from repro_torch.mem import resolve_window
from test_torch_apps import graph, run
from test_torch_engine import SMALL, TIGHT, assert_stats_equal, \
    port_partition
from test_torch_fused_leg import assert_all_stats_equal
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

SPACE_DEPENDENT = ("cycles", "energy_pj", "hbm_windows", "hbm_edges",
                   "launches")


def segments(rng, e_chunk, max_t2, R, ragged_last):
    """Range messages as range_split emits them (tests/test_memspace.py):
    each <= max_t2 edges, not crossing the chunk border, on a global edge
    index of tile 1; some invalid, carrying -1."""
    length = rng.integers(1, max_t2 + 1, size=R).astype(np.int32)
    local0 = (rng.integers(0, e_chunk, size=R) % (e_chunk - length)) \
        .astype(np.int32)
    if ragged_last:  # a segment ending exactly at the chunk border
        length[-1] = max_t2
        local0[-1] = e_chunk - max_t2
    rv = rng.random(R) < 0.8
    rv[0] = True
    start = np.where(rv, e_chunk + local0, -1).astype(np.int32)
    return start, (start + length).astype(np.int32), rv


def check_stream_tiles(edge_dst, edge_val, start, stop, rv, max_t2,
                       window):
    """The port's batched segment_stream and its wrapper against the JAX
    body and Pallas kernel, tile by tile, on every element."""
    args = [torch.from_numpy(a) for a in (edge_dst, edge_val, start, stop,
                                          rv)]
    got = segment_stream(*args, max_t2, window)
    with tally() as t:
        wrapped = edge_scan_stream(*args, max_t2, window)
    assert t.n == 1
    for a, b in zip(got, wrapped):
        assert torch.equal(a, b)
    for tile in range(edge_dst.shape[0]):
        ops = [jnp.asarray(a[tile]) for a in (edge_dst, edge_val, start,
                                              stop, rv)]
        body = jk.segment_stream(*ops, max_t2, window)
        kern = jk.edge_scan_stream(*ops, max_t2, window, interpret=True)
        for want in (body, kern):
            for a, b in zip(want, got):
                a, b = np.asarray(a), b[tile].numpy()
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(
                    a.view(np.int32) if a.dtype == np.float32 else a,
                    b.view(np.int32) if b.dtype == np.float32 else b)
    return got


@pytest.mark.parametrize("window_mult,ragged", [(1, False), (1, True),
                                                (2, False), (16, True)])
def test_segment_stream_equals_jax(window_mult, ragged):
    rng = np.random.default_rng(7)
    T, e_chunk, max_t2, R = 2, 256, 8, 24
    window = max_t2 * window_mult  # window == max_t2 is the tight corner
    edge_dst = rng.integers(-1, 64, size=(T, e_chunk)).astype(np.int32)
    edge_val = rng.random((T, e_chunk)).astype(np.float32)
    cols = [segments(rng, e_chunk, max_t2, R, ragged) for _ in range(T)]
    start, stop, rv = (np.stack(c) for c in zip(*cols))
    nb, w, jv = check_stream_tiles(edge_dst, edge_val, start, stop, rv,
                                   max_t2, window)
    # valid lanes read what the resident gather reads
    g = jk.segment_gather(jnp.asarray(edge_dst[1]),
                          jnp.asarray(edge_val[1]), jnp.asarray(start[1]),
                          jnp.asarray(stop[1]), jnp.asarray(rv[1]), max_t2)
    live = jv[1].numpy()
    np.testing.assert_array_equal(np.asarray(g[2]), live)
    np.testing.assert_array_equal(np.asarray(g[0])[live], nb[1].numpy()[live])


def test_segment_stream_empty_frontier():
    e_chunk, max_t2, window = 64, 8, 8
    edge_dst = np.tile(np.arange(e_chunk, dtype=np.int32), (2, 1))
    edge_val = np.ones((2, e_chunk), dtype=np.float32)
    z = np.zeros((2, 4), dtype=np.int32)
    rv = np.zeros((2, 4), dtype=bool)
    _, _, jv = check_stream_tiles(edge_dst, edge_val, z, z, rv, max_t2,
                                  window)
    assert not jv.any()


def drawn_scan(rng, T, e_chunk, R, max_t2):
    """Scan operands beyond what range_split emits: starts anywhere in the
    tiles' global range or -1, lengths from -4 to max_t2 + 4 (negative,
    and past max_t2), a third of the messages invalid, shards that may be
    shorter than max_t2 or a window."""
    edge_dst = rng.integers(-1, 1 << 20, (T, e_chunk)).astype(np.int32)
    edge_val = rng.normal(0, 4, (T, e_chunk)).astype(np.float32)
    start = rng.integers(0, T * e_chunk, (T, R)).astype(np.int32)
    stop = (start + rng.integers(-4, max_t2 + 5, (T, R))).astype(np.int32)
    rv = rng.random((T, R)) < 0.67
    start = np.where(rv | (rng.random((T, R)) < 0.5), start, -1)
    return edge_dst, edge_val, start.astype(np.int32), stop, rv


def test_segment_stream_is_segment_gather_on_every_lane():
    """With window >= max_t2, the port's segment_stream gives
    segment_gather's bits on every lane, valid or not: 300 drawn cases
    (windows equal to max_t2 and up to 64 times it, shards shorter than a
    window or than max_t2, negative lengths, starts of -1).  So the
    streamed kernel reads each lane's word where the gather does."""
    from repro_torch.kernels.engine.kernel import segment_gather
    rng = np.random.default_rng(26)
    for trial in range(300):
        T = int(rng.integers(1, 4))
        max_t2 = int(rng.integers(1, 40))
        window = max_t2 * int(rng.choice([1, 1, 2, 3, 16, 64]))
        e_chunk = int(rng.integers(1, 3 * window + 2))
        R = int(rng.integers(1, 12))
        args = [torch.from_numpy(a) for a in drawn_scan(
            rng, T, e_chunk, R, max_t2)]
        for a, b in zip(segment_stream(*args, max_t2, window),
                        segment_gather(*args, max_t2)):
            assert torch.equal(a, b), (trial, T, e_chunk, R, max_t2, window)


@pytest.mark.parametrize("max_t2,window,e_chunk", [(8, 8, 5), (7, 14, 40),
                                                   (32, 512, 300)])
def test_jax_segment_stream_is_segment_gather_on_every_lane(max_t2, window,
                                                            e_chunk):
    """The same identity in the JAX package's bodies, and the port's
    segment_stream against them, on 20 drawn tiles each (the window equal
    to max_t2 over a shard shorter than it, twice it, 16 times it over a
    shard shorter than two windows)."""
    rng = np.random.default_rng(max_t2)
    ops = drawn_scan(rng, 20, e_chunk, 8, max_t2)
    j = [jnp.asarray(a) for a in ops]
    body = jax.vmap(lambda *a: jk.segment_stream(*a, max_t2, window))(*j)
    gather = jax.vmap(lambda *a: jk.segment_gather(*a, max_t2))(*j)
    port = segment_stream(*[torch.from_numpy(a) for a in ops], max_t2,
                          window)
    for a, b, c in zip(body, gather, port):
        a, b, c = np.asarray(a), np.asarray(b), c.numpy()
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_edge_scan_stream_rejects_a_window_below_max_t2():
    z = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="window"):
        edge_scan_stream(z, z.float(), z, z, z.bool(), 8, 4)


@pytest.fixture(scope="module")
def g6():
    n, src, dst, val = rmat_edges(6, edge_factor=5, seed=1)
    return CSRGraph.from_edges(n, src, dst, val)


# name: (app, rmat scale, T, knobs)
UNFUSED = {
    "bfs-s7-T4-tight": ("bfs", 7, 4, TIGHT),
    "sssp-s6-T4-small": ("sssp", 6, 4, SMALL),
    "spmv-s7-T16-small": ("spmv", 7, 16, SMALL),
}


@pytest.mark.parametrize("case", sorted(UNFUSED))
def test_hbm_unfused_bitwise_equals_jax_xla(case):
    app, scale, T, knobs = UNFUSED[case]
    g = graph(app, scale, T)
    pg = ja.prepare(g, T=T)
    cfg = dict(knobs, edge_space="hbm")
    jx = run(ja, app, pg, g, JConfig(backend="xla", **cfg))
    tp = run(ta, app, port_partition(pg), g, TConfig(fuse=False, **cfg))
    np.testing.assert_array_equal(jx.values, tp.values)
    assert_stats_equal(jx.stats, tp.stats, f"{app} hbm")
    st = tp.stats
    assert int(st.launches) == 5 * int(st.rounds)
    assert int(st.hbm_windows) > 0
    assert int(st.hbm_edges) == int(st.hbm_windows) * resolve_window(
        0, knobs["max_t2"])


@pytest.mark.parametrize("mode", ["async", "bsp"])
def test_hbm_kcore_bitwise_equals_jax_xla(mode):
    n, src, dst, val = rmat_edges(6, edge_factor=5, seed=2)
    gs = ja.symmetrize(CSRGraph.from_edges(n, src, dst, val))
    pg = ja.prepare(gs, T=4)
    cfg = dict(SMALL, edge_space="hbm", mode=mode)
    jx = ja.kcore(pg, 2, JConfig(backend="xla", **cfg))
    tp = ta.kcore(port_partition(pg), 2, TConfig(fuse=False, **cfg))
    np.testing.assert_array_equal(jx.values, tp.values)
    assert_stats_equal(jx.stats, tp.stats, f"kcore hbm {mode}")
    assert int(tp.stats.hbm_edges) > 0


@pytest.mark.parametrize("app", ["bfs", "spmv"])
def test_hbm_fused_bitwise_equals_jax_fused(app, g6):
    pg = ja.prepare(g6, T=4)
    cfg = dict(TIGHT, edge_space="hbm")
    jf = run(ja, app, pg, g6, JConfig(backend="pallas", **cfg))
    tf = run(ta, app, port_partition(pg), g6, TConfig(fuse=True, **cfg))
    np.testing.assert_array_equal(jf.values, tf.values)
    assert_all_stats_equal(jf.stats, tf.stats, f"{app} hbm fused")
    assert int(tf.stats.launches) == 3 * int(tf.stats.rounds)
    assert int(tf.stats.hbm_windows) > 0


def test_beyond_vmem_budget_runs_hbm(g6):
    """A tile budget the resident shard cannot fit rejects the all-VMEM
    layout at validation, while the streamed layout (explicit window =
    max_t2) runs and equals the unconstrained resident run in values and
    every space-independent Stats field (tests/test_memspace.py:287)."""
    tpg = port_partition(ja.prepare(g6, T=4))
    root = int(np.argmax(g6.ptr[1:] - g6.ptr[:-1]))
    base = TConfig(**SMALL)
    hbm = TConfig(edge_space="hbm", hbm_window=base.max_t2, **SMALL)
    prog = as_program(BFS)

    def vmem_bytes(c):
        return sum(b for _, sp, b in
                   prog.tile_decls(c, tpg.T, tpg.e_chunk, tpg.v_chunk)
                   if sp == "vmem")

    limit = (vmem_bytes(hbm) + vmem_bytes(base)) // 2
    with pytest.raises(ValueError, match="over budget"):
        ta.bfs(tpg, root, dataclasses.replace(base, vmem_limit_bytes=limit))
    r_vmem = ta.bfs(tpg, root, base)
    for fuse in (False, True):
        r_hbm = ta.bfs(tpg, root, dataclasses.replace(
            hbm, vmem_limit_bytes=limit, fuse=fuse))
        np.testing.assert_array_equal(r_hbm.values, r_vmem.values)
        for f in r_vmem.stats._fields:
            if f not in SPACE_DEPENDENT:
                np.testing.assert_array_equal(
                    getattr(r_hbm.stats, f).numpy(),
                    getattr(r_vmem.stats, f).numpy(), err_msg=f)
        assert int(r_hbm.stats.hbm_edges) == \
            int(r_hbm.stats.hbm_windows) * base.max_t2 > 0
        assert float(r_hbm.stats.cycles) > float(r_vmem.stats.cycles)
    np.testing.assert_array_equal(
        r_vmem.values, tref.bfs_ref(TCSRGraph(g6.ptr, g6.dst, g6.val), root))
