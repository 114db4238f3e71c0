"""Query serving on the port (``repro_torch.serve``) against its own solo
runs and against the JAX package's ``repro.serve``.

* Each lane of a batched ``multi_source`` run is its solo
  ``repro_torch.core.algorithms.bfs`` / ``sssp`` run at the same config
  and backend, bit for bit: values and every Stats field, ``launches``
  included (three a round on the default fused path); a padding lane is
  born finished; ``total_rounds`` is the largest lane count and
  ``done_round`` each lane's own.  The sizes are ``tests/test_serve.py``'s
  (R-MAT-7, edge factor 5, T = 8, its ``small_cfg``).
* Each lane equals the JAX package's ``multi_source`` lane
  (``backend="xla"``) in values and every Stats field but ``launches``,
  on the ideal crossbar and the mesh, async and BSP; the batch clock and
  energy too.
* The front ends: static ``burst`` / ``poisson`` and continuous reports
  equal the reference's ``ServeReport.row()``; continuous recycling with
  the trace on gives each record its solo run's ring; ``lane_trace`` of a
  lane-led ring is the solo ring.

The lane axis of the kernels and ``LaneComm`` are held in
``tests/test_torch_lane_kernels.py`` (no JAX: its card tests run on the
card's machine).
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.core import algorithms as ja
from repro.core import reference as ref
from repro.core.engine import EngineConfig as JConfig
from repro.core.graph import CSRGraph, rmat_edges
from repro.serve import Frontend as JFrontend
from repro.serve import multi_source as jmulti
from repro.trace.export import lane_trace as jlane_trace
from repro_torch.configs import dalorex_graph
from repro_torch.core import algorithms as ta
from repro_torch.core.engine import EngineConfig as TConfig
from repro_torch.core.program import BFS
from repro_torch.serve import Frontend, multi_source, spmd_lanes_call
from repro_torch.serve.__main__ import main as serve_main
from repro_torch.trace import TraceBuf, lane_trace
from test_torch_engine import port_partition
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

# tests/test_serve.py's small_cfg knobs
SMALL = dict(f_pop=8, r_pop=8, u_pop=16, max_t2=8, cap_route_range=8,
             cap_route_update=32, cap_rangeq=256, cap_updq=4096,
             max_rounds=20000)
FABRICS = {"ideal": {}, "mesh": dict(noc="mesh", link_cap=2)}


@pytest.fixture(scope="module")
def g():
    n, src, dst, val = rmat_edges(7, edge_factor=5, seed=0)
    return CSRGraph.from_edges(n, src, dst, val)


@pytest.fixture(scope="module")
def pgs(g):
    jpg = ja.prepare(g, T=8)
    return jpg, port_partition(jpg)


def sources_of(g, n, seed=0):
    deg = np.asarray(g.ptr[1:] - g.ptr[:-1])
    return [int(s) for s in np.random.default_rng(seed).choice(
        np.flatnonzero(deg > 0), size=n)]


def bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_lane_is_solo(res, lane, solo, where):
    """Lane ``lane`` of a port BatchResult == a port solo Result, bit for
    bit: values and the whole Stats tuple, launches included."""
    np.testing.assert_array_equal(res.values[lane], solo.values,
                                  err_msg=where)
    for f, a, b in zip(solo.stats._fields, res.stats, solo.stats):
        np.testing.assert_array_equal(bits(a[lane].cpu()), bits(b.cpu()),
                                      err_msg=f"Stats.{f} lane {lane} "
                                              f"({where})")


def assert_lanes_match_jax(res, jres, where):
    """Every lane of a port BatchResult == the JAX BatchResult's, values
    and every Stats field but ``launches``; rounds, clocks and stamps."""
    np.testing.assert_array_equal(res.values, jres.values, err_msg=where)
    for f, a, b in zip(res.stats._fields, res.stats, jres.stats):
        if f == "launches":
            continue
        a, b = a.cpu().numpy(), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (where, f)
        np.testing.assert_array_equal(bits(a), bits(b),
                                      err_msg=f"Stats.{f} ({where})")
    assert res.total_rounds == jres.total_rounds, where
    np.testing.assert_array_equal(res.done_round, jres.done_round)
    np.testing.assert_array_equal(bits(res.done_cycle),
                                  bits(jres.done_cycle), err_msg=where)
    assert np.float32(res.batch_cycles) == np.float32(jres.batch_cycles)
    assert bits(np.float32(res.batch_energy_pj)) == \
        bits(np.float32(jres.batch_energy_pj)), where


# --------------------------------------------------------------------------
# Lanes against solo runs and against the JAX package.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["async", "bsp"])
@pytest.mark.parametrize("fabric", sorted(FABRICS))
def test_lanes_bitwise_equal_solo_and_jax(g, pgs, fabric, mode):
    """B = 5 (two sources, a duplicate, a padding lane, a third source) on
    the default fused path: each lane == the JAX lane (every field but
    launches), three launches a lane and round, duplicates equal, padding
    born finished; on the crossbar, async, each lane == its port solo run
    too, launches included (the JAX tests hold the JAX lanes to the JAX
    solo runs, and the engine tests the port's solo runs to those)."""
    kw = dict(SMALL, mode=mode, **FABRICS[fabric])
    srcs = sources_of(g, 3, seed=1)
    batch = [srcs[0], srcs[1], srcs[0], -1, srcs[2]]
    res = multi_source(pgs[1], "bfs", batch, TConfig(**kw))
    jres = jmulti(pgs[0], "bfs", batch, JConfig(backend="xla", **kw))
    where = f"{fabric} {mode}"
    assert_lanes_match_jax(res, jres, where)
    solos = ({s: ta.bfs(pgs[1], s, TConfig(**kw)) for s in srcs}
             if (fabric, mode) == ("ideal", "async") else {})
    for lane, s in enumerate(batch):
        if s >= 0:
            if solos:
                assert_lane_is_solo(res, lane, solos[s], where)
            np.testing.assert_array_equal(res.values[lane],
                                          ref.bfs_ref(g, s))
    np.testing.assert_array_equal(res.values[0], res.values[2])
    assert np.isinf(res.values[3]).all()
    assert int(res.stats.rounds[3]) == 0 and int(res.done_round[3]) == 0
    assert int(res.stats.launches[3]) == 0
    lane_rounds = res.stats.rounds.tolist()
    assert res.total_rounds == max(lane_rounds) < res.seq_rounds
    np.testing.assert_array_equal(res.done_round, lane_rounds)
    assert res.stats.launches.tolist() == [3 * r for r in lane_rounds]
    assert int(res.stats.drops.sum()) == 0
    if fabric == "mesh":  # the capped links spill and replay
        assert int(res.stats.spills.sum()) > 0


@pytest.mark.parametrize("backend,fuse", [("torch", False),
                                          ("kernels", False)])
def test_lanes_on_the_other_paths(g, pgs, backend, fuse):
    """The unfused kernel path (five launches a round a lane) and the
    inline "torch" path (none): each lane == its solo run on that path."""
    cfg = TConfig(backend=backend, fuse=fuse, **SMALL)
    srcs = sources_of(g, 3, seed=8)
    res = multi_source(pgs[1], "bfs", srcs + [-1], cfg)
    for lane, s in enumerate(srcs):
        assert_lane_is_solo(res, lane, ta.bfs(pgs[1], s, cfg), backend)
    per_round = 5 if backend == "kernels" else 0
    assert res.stats.launches.tolist() == [
        per_round * r for r in res.stats.rounds.tolist()]


def test_sssp_lanes_and_done_rounds(g, pgs):
    """SSSP lanes == solo and == the JAX lanes; ``done_round`` of each
    lane is its solo round count."""
    srcs = sources_of(g, 4, seed=2)
    res = multi_source(pgs[1], "sssp", srcs, TConfig(**SMALL))
    jres = jmulti(pgs[0], "sssp", srcs, JConfig(backend="xla", **SMALL))
    assert_lanes_match_jax(res, jres, "sssp")
    for lane, s in enumerate(srcs):
        solo = ta.sssp(pgs[1], s, TConfig(**SMALL))
        assert_lane_is_solo(res, lane, solo, "sssp")
        assert int(res.done_round[lane]) == int(solo.stats.rounds)
        np.testing.assert_array_equal(res.values[lane], ref.sssp_ref(g, s))


def test_b1_batch_clock_equals_solo_accumulators(g, pgs):
    """One lane: the batch makespan and energy are the solo run's Kahan
    accumulators, bit for bit."""
    s = sources_of(g, 1, seed=4)[0]
    res = multi_source(pgs[1], "bfs", [s], TConfig(**SMALL))
    solo = ta.bfs(pgs[1], s, TConfig(**SMALL))
    assert bits(np.float32(res.batch_cycles)) == bits(solo.stats.cycles)
    assert bits(np.float32(res.batch_energy_pj)) == \
        bits(solo.stats.energy_pj)
    assert float(res.done_cycle[0]) == res.batch_cycles


def test_multi_source_rejects_non_point_queries(pgs):
    with pytest.raises(ValueError, match="bfs/sssp"):
        multi_source(pgs[1], "pagerank", [0], TConfig(**SMALL))


def test_unported_options_raise_naming_their_roadmap_items(g, pgs):
    """A mesh, once refused, runs (tests/test_torch_spmd.py); a "cuda"
    mesh without a GPU raises rather than falling back to the CPU, and
    continuous batching on a mesh is refused as the reference refuses it.
    Between-batch adaptation, once refused, runs: its report equals the
    reference's, and without ``graph=`` it raises the reference's
    ``ValueError``."""
    pg = pgs[1]
    cuda_mesh = SimpleNamespace(device_type="cuda", mesh_dim_names=("x",))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            multi_source(pg, "bfs", [0], TConfig(**SMALL), mesh=cuda_mesh)
        with pytest.raises(RuntimeError, match="CUDA"):
            spmd_lanes_call(pg, BFS, TConfig(**SMALL), None, None,
                            cuda_mesh)
        with pytest.raises(RuntimeError, match="CUDA"):
            Frontend(pg, cfg=TConfig(**SMALL), mesh=cuda_mesh).serve([0])
    with pytest.raises(ValueError, match="LocalComm"):
        Frontend(pg, policy="continuous", mesh=object())
    with pytest.raises(ValueError, match="graph"):
        Frontend(pg, cfg=TConfig(adapt=True, **SMALL))
    kw = dict(SMALL, adapt=True, adapt_every=1, adapt_budget=8)
    srcs = sources_of(g, 4, seed=5)
    rep = Frontend(pg, cfg=TConfig(**kw), width=2, graph=g).serve(srcs)
    jrep = JFrontend(pgs[0], cfg=JConfig(backend="xla", **kw), width=2,
                     graph=g).serve(srcs)
    check_records(g, rep, jrep)
    assert rep.migrated_vertices == jrep.migrated_vertices > 0
    for kw, msg in ((dict(app="wcc"), "bfs/sssp"),
                    (dict(policy="adaptive"), "policy"),
                    (dict(width=0), "width")):
        with pytest.raises(ValueError, match=msg):
            Frontend(pg, **kw)


# --------------------------------------------------------------------------
# Front ends against the reference's rows.
# --------------------------------------------------------------------------

def check_records(g, rep, jrep):
    """The records against the reference's, field for field, and each
    record's values against the oracle."""
    assert rep.row() == jrep.row()
    assert len(rep.records) == len(jrep.records) and rep.drops == 0
    for a, b in zip(rep.records, jrep.records):
        assert (a.qid, a.source, a.enqueue_cycle, a.admit_cycle,
                a.complete_cycle, a.rounds, a.edges) == (
            b.qid, b.source, b.enqueue_cycle, b.admit_cycle,
            b.complete_cycle, b.rounds, b.edges)
        np.testing.assert_array_equal(a.values, b.values)
        np.testing.assert_array_equal(a.values, ref.bfs_ref(g, a.source))


@pytest.mark.parametrize("arrival,gap", [("burst", 0.0),
                                         ("poisson", 3000.0)])
def test_static_report_equals_reference(g, pgs, arrival, gap):
    """Static batches of 4 (the last one padded): the row and every
    record equal to the reference's."""
    srcs = sources_of(g, 6, seed=6)
    rep = Frontend(pgs[1], cfg=TConfig(**SMALL), width=4).serve(
        srcs, arrival=arrival, gap=gap, seed=0)
    jrep = JFrontend(pgs[0], cfg=JConfig(backend="xla", **SMALL),
                     width=4).serve(srcs, arrival=arrival, gap=gap, seed=0)
    check_records(g, rep, jrep)
    assert rep.batches >= 2 and rep.total_rounds < rep.seq_rounds


def test_continuous_recycling_keeps_solo_rings(g, pgs):
    """Continuous batching with the trace on: 5 queries through 2 lanes
    (recycled lanes), the row and records equal to the reference's, and
    each record's rounds, edges, values and lane ring those of its port
    solo run."""
    cfg = TConfig(trace=True, trace_rounds=256, **SMALL)
    srcs = sources_of(g, 5, seed=7)
    rep = Frontend(pgs[1], cfg=cfg, width=2, policy="continuous").serve(
        srcs, arrival="poisson", gap=2000.0, seed=0)
    jrep = JFrontend(pgs[0], cfg=JConfig(backend="xla", **SMALL), width=2,
                     policy="continuous").serve(srcs, arrival="poisson",
                                                gap=2000.0, seed=0)
    check_records(g, rep, jrep)
    assert rep.total_rounds < rep.seq_rounds and rep.batches > 2
    for rec in rep.records:
        solo = ta.bfs(pgs[1], rec.source, cfg)
        assert (rec.rounds, rec.edges) == (int(solo.stats.rounds),
                                           int(solo.stats.edges_scanned))
        np.testing.assert_array_equal(rec.values, solo.values)
        assert_rings_equal(solo.trace, rec.trace, f"query {rec.qid}")


def assert_rings_equal(want, got, where, launches=True):
    """Two rings bitwise, field for field (``cursor`` as a number)."""
    assert int(np.asarray(want.cursor)) == int(got.cursor), where
    for f in TraceBuf._fields[1:]:
        if f == "launches" and not launches:
            continue
        w = np.asarray(getattr(want, f).cpu() if hasattr(
            getattr(want, f), "cpu") else getattr(want, f))
        gg = getattr(got, f).cpu().numpy()
        assert w.shape == gg.shape and w.dtype == gg.dtype, (where, f)
        np.testing.assert_array_equal(bits(w), bits(gg),
                                      err_msg=f"{where}: {f}")


def test_lane_trace_of_a_lane_led_ring(g, pgs):
    """multi_source with the trace on: each ``lane_trace`` of the
    lane-led ring is the solo run's ring (launches included) and the JAX
    lane's ring (but launches); values and Stats as with the trace off."""
    srcs = sources_of(g, 3, seed=9)
    batch = srcs + [-1]
    cfg1 = TConfig(trace=True, trace_rounds=256, **SMALL)
    res0 = multi_source(pgs[1], "bfs", batch, TConfig(**SMALL))
    res1 = multi_source(pgs[1], "bfs", batch, cfg1)
    assert res0.trace is None and res1.trace is not None
    np.testing.assert_array_equal(res0.values, res1.values)
    for f, a, b in zip(res0.stats._fields, res0.stats, res1.stats):
        assert torch.equal(a, b), f
    jres = jmulti(pgs[0], "bfs", batch, JConfig(
        backend="xla", trace=True, trace_rounds=256, **SMALL))
    for lane, s in enumerate(batch):
        got = lane_trace(res1.trace, lane)
        assert_rings_equal(jlane_trace(jres.trace, lane), got,
                           f"lane {lane} vs JAX", launches=False)
        if s >= 0:
            assert_rings_equal(ta.bfs(pgs[1], s, cfg1).trace, got,
                               f"lane {lane} vs solo")
        else:
            assert int(got.cursor) == 0
            assert (got.round_id == -1).all()


def test_serve_cli_runs_on_the_cpu(capsys, monkeypatch):
    # the preset table at a small size: R-MAT-6 on 4 tiles
    small = dataclasses.replace(dalorex_graph.get_workload("rmat-small"),
                                scale=6, tiles=4)
    monkeypatch.setattr(dalorex_graph, "get_workload", lambda name: small)
    assert serve_main(["--preset", "rmat-small", "--queries", "3",
                       "--batch", "2", "--policy", "continuous",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("# preset=rmat-small V=64 T=4")
    row = dict(kv.split("=") for kv in out[1].split(","))
    assert row["queries"] == "3" and row["drops"] == "0"
