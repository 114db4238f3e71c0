"""The graph side's last functions against the JAX package's on the same
inputs — ``perf.model`` ``serving_metrics`` / ``derived_metrics``,
``core.routing`` ``route_stats``, ``core.queues`` ``queue_free``, ``mem``
``register`` — and ``examples/graph_analytics_torch.py`` at a small scale
on the CPU.  Every comparison is exact: the columns are rounded host
numbers of the same float32 Stats, the histograms integers.
"""
import importlib.util
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.mem as JM
from repro.core import comm as JCOMM
from repro.core import queues as JQ
from repro.core.routing import route_stats as j_route_stats
from repro.perf import model as JP
from repro.trace.buffer import TraceBuf as JTraceBuf
import repro_torch.mem as TM
from repro_torch.core import algorithms as alg
from repro_torch.core.comm import LocalComm
from repro_torch.core.engine import EngineConfig
from repro_torch.core.graph import CSRGraph, rmat_edges
from repro_torch.core.queues import Queue, queue_free
from repro_torch.core.routing import route_stats
from repro_torch.perf import derived_metrics, serving_metrics
from repro_torch.perf.model import PerfParams
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.mark.parametrize("queries,cycles,energy,edges", [
    (8, 123456.0, 9.87e6, 40000), (1, 3.5, 0.25, 0), (0, 0.0, 0.0, 0)])
def test_serving_metrics_match_jax(queries, cycles, energy, edges):
    want = JP.serving_metrics(queries, cycles, energy, edges)
    assert serving_metrics(queries, cycles, energy, edges) == want
    fast = dict(f_ghz=2.0)
    assert serving_metrics(queries, cycles, energy, edges,
                           PerfParams(**fast)) == \
        JP.serving_metrics(queries, cycles, energy, edges,
                           JP.PerfParams(**fast))


def traced_bfs():
    """A traced BFS on R-MAT-6 over 4 tiles: its Stats and ring."""
    n, src, dst, val = rmat_edges(6, edge_factor=8, seed=1)
    g = CSRGraph.from_edges(n, src, dst, val)
    pg = alg.prepare(g, 4, device="cpu")
    cfg = EngineConfig(backend="torch", trace=True, trace_rounds=64)
    return alg.bfs(pg, 0, cfg)


def test_derived_metrics_match_jax_on_a_traced_run():
    """The columns of a traced run's Stats, with and without T and the
    ring, against the reference's on the same numbers (the ring carried
    across field by field)."""
    res = traced_bfs()
    s = res.stats
    js = SimpleNamespace(**{k: np.asarray(getattr(s, k)) for k in
                            ("cycles", "edges_scanned", "energy_pj",
                             "hbm_edges")})
    jring = JTraceBuf(*(np.asarray(x) for x in res.trace))
    assert derived_metrics(s) == JP.derived_metrics(js)
    got = derived_metrics(s, T=4, trace=res.trace)
    assert got == JP.derived_metrics(js, T=4, trace=jring)
    assert {"leak_pj", "leak_frac", "util_mean", "work_cov"} <= set(got)


def test_derived_metrics_split_a_streamed_runs_energy_like_jax():
    """A run whose edge shard streamed from HBM adds the energy split by
    space (the reference's additive columns)."""
    f = torch.float32
    s = SimpleNamespace(cycles=torch.tensor(5.0e5, dtype=f),
                        edges_scanned=torch.tensor(123456),
                        energy_pj=torch.tensor(7.5e7, dtype=f),
                        hbm_edges=torch.tensor(4096))
    js = SimpleNamespace(**{k: np.asarray(v) for k, v in vars(s).items()})
    got = derived_metrics(s, T=16)
    assert got == JP.derived_metrics(js, T=16)
    assert {"hbm_pj", "hbm_frac", "pj_per_edge_hbm",
            "pj_per_edge_sram"} <= set(got)


@pytest.mark.parametrize("T,n,shards", [(4, 16, 4), (3, 7, 5)])
def test_route_stats_match_jax(T, n, shards):
    rng = np.random.default_rng(T * n)
    valid = rng.random((T, n)) < 0.6
    dest = rng.integers(0, shards, (T, n)).astype(np.int32)
    want = j_route_stats(JCOMM.LocalComm(T), jnp.asarray(valid),
                         jnp.asarray(dest), shards)
    got = route_stats(LocalComm(T), torch.from_numpy(valid),
                      torch.from_numpy(dest), shards)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_queue_free_matches_jax_tile_by_tile():
    rng = np.random.default_rng(0)
    data = rng.integers(0, 9, (3, 8, 2)).astype(np.int32)
    count = np.array([0, 5, 8], np.int32)
    got = queue_free(Queue(torch.from_numpy(data), torch.from_numpy(count)))
    for t in range(3):
        want = JQ.queue_free(JQ.Queue(jnp.asarray(data[t]),
                                      jnp.asarray(count[t])))
        assert int(got[t]) == int(want)


def test_register_adds_a_space_like_jax(monkeypatch):
    """A registered space is found by name and allocates the kinds it
    holds, in both packages; the registries are restored after."""
    monkeypatch.setattr(TM, "_REGISTRY", dict(TM._REGISTRY))
    monkeypatch.setattr(JM, "_REGISTRY", dict(JM._REGISTRY))
    kw = dict(name="sram2", capacity_bytes=1 << 20, window=8,
              kinds=("queue",))
    tsp, jsp = TM.register(TM.MemSpace(**kw)), JM.register(JM.MemSpace(**kw))
    assert TM.get_space("sram2") is tsp and JM.get_space("sram2") is jsp
    assert sorted(TM._REGISTRY) == sorted(JM._REGISTRY)
    assert TM.check_alloc("sram2", "queue", "q") is tsp
    for mod in (TM, JM):
        with pytest.raises(ValueError, match="cannot live"):
            mod.check_alloc("sram2", "edge", "shard")
    TM.register(TM.MemSpace("sram2", 1 << 10))  # replaces
    assert TM.get_space("sram2").capacity_bytes == 1 << 10


def test_graph_analytics_example_on_the_cpu(capsys):
    """``examples/graph_analytics_torch.py --device cpu`` in-process at
    scale 6 over 4 tiles, plain backend (the kernels need the card): the
    script asserts every workload against its oracle, so it must return
    0; every row says OK."""
    spec = importlib.util.spec_from_file_location(
        "graph_analytics_torch",
        os.path.join(ROOT, "examples", "graph_analytics_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(["--scale", "6", "--tiles", "4", "--backend", "torch",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "FAIL" not in out and out.count(" OK") == 13
    assert "hier+dielocal" in out and "triangles" in out
