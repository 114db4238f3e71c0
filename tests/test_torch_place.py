"""Adaptive placement on the port (``repro_torch.place``) against the JAX
package's ``repro.place``, on the same inputs.

The sizes are ``tests/test_place.py``'s: R-MAT-7, edge factor 5, seed 3,
unit weights, T = 8, its ``small_cfg`` knobs.

* Plans, pair for pair and reason for reason: ``placed_edges``,
  ``indegree_mass`` and ``vertex_die_affinity`` equal the reference's;
  ``migration_plan`` on the flat partition and on ``low_order_dielocal``
  over (2, 1) and (2, 2) dies, flat and over (2, 2) on a graph of 97
  vertices (partitions with padding slots, which the planner fills
  first), busy vectors ``None``, two seeds and one with ties, budgets
  0, 16 and 256;
  ``validate_plan`` raises as the reference does.
* Partitions: ``apply_plan``'s arrays equal the JAX package's in every
  edge mode and for the ``sorted_adj`` triangle partition.
* The migrator's helpers and pricing: ``swap_permutation``,
  ``remap_state``, ``migration_words`` equal; ``price_migration`` gives
  every Stats field the reference's bits; ``energy_from_totals``,
  ``flits_by_class`` and ``die_crossing_frac`` equal the reference's.
* Runs: BFS on a migrated partition, ``adaptive_pagerank`` (dyadic and
  general instances) and the static ``Frontend`` with ``adapt=True``,
  values and Stats bitwise the JAX package's (``backend="xla"``) but
  ``launches``.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro import place as jp
from repro.core import algorithms as ja
from repro.core.engine import EngineConfig as JConfig
from repro.core.graph import CSRGraph, rmat_edges
from repro.noc.network import make_network as jmake_network
from repro.noc.topology import tile_die_map
from repro.perf import model as jmodel
from repro.serve import Frontend as JFrontend
from repro_torch import place as tp
from repro_torch.core import algorithms as ta
from repro_torch.core.engine import EngineConfig as TConfig
from repro_torch.noc import make_network
from repro_torch.perf import model as tmodel
from repro_torch.serve import Frontend
from test_torch_engine import assert_stats_equal
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                      # dev extra (requirements-dev.txt)
    HAVE_HYPOTHESIS = False

# tests/test_place.py's small_cfg knobs
SMALL = dict(f_pop=8, r_pop=8, u_pop=16, max_t2=8, cap_route_range=8,
             cap_route_update=32, cap_rangeq=128, cap_updq=4096,
             max_rounds=5000)
T = 8
HIER = dict(noc="hier", ndies_y=2, ndies_x=2)
# name: (placement, dies (ndies_y, ndies_x) or None, padded graph?)
PARTITIONS = {"flat": ("low_order", None, False),
              "dielocal 2x1": ("low_order_dielocal", (2, 1), False),
              "dielocal 2x2": ("low_order_dielocal", (2, 2), False),
              "flat padded": ("low_order", None, True),
              "dielocal 2x2 padded": ("low_order_dielocal", (2, 2), True)}
PADDED_V = 97   # 7 padding slots over T = 8
# None (the in-degree fallback), two drawn vectors, and one with tied
# hottest and coldest tiles (argmax / argmin take the first)
BUSY = {"none": None, "seed 0": 0, "seed 1": 1,
        "ties": np.array([3.0, 1.0, 3.0, 2.0, 2.0, 2.0, 2.0, 1.0])}
BUDGETS = (0, 16, 256)


@pytest.fixture(scope="module")
def graph():
    # unit weights: the pagerank instances stay exactly representable
    n, src, dst, _ = rmat_edges(7, edge_factor=5, seed=3)
    return CSRGraph.from_edges(n, src, dst, None)


@pytest.fixture(scope="module")
def padded(graph):
    """The R-MAT-7 graph cut to its first PADDED_V vertices: its
    partitions hold padding slots, which the planner fills first."""
    src = np.repeat(np.arange(graph.num_vertices), np.diff(graph.ptr))
    keep = (src < PADDED_V) & (graph.dst < PADDED_V)
    return CSRGraph.from_edges(PADDED_V, src[keep], graph.dst[keep], None)


@pytest.fixture(scope="module")
def gsym(graph):
    return ja.symmetrize(graph)


def tile_die_of(dies):
    return None if dies is None else tile_die_map(T, 0, *dies)


def both(g, scheme="low_order", dies=None, edge_mode="equal_edges"):
    """The JAX partition and the port's own (on the CPU), array for array
    the same."""
    jpg = ja.prepare(g, T, scheme=scheme, dies=dies, edge_mode=edge_mode)
    tpg = ta.prepare(g, T, scheme=scheme, dies=dies, edge_mode=edge_mode,
                     device="cpu")
    assert_partitions_equal(jpg, tpg, f"{scheme} {edge_mode}")
    return jpg, tpg


def assert_partitions_equal(jpg, tpg, where):
    for f in ("ptr_start", "deg", "edge_dst", "edge_val"):
        a, b = np.asarray(getattr(jpg, f)), getattr(tpg, f).numpy()
        assert a.dtype == b.dtype, (where, f)
        np.testing.assert_array_equal(a, b, err_msg=f"{where}: {f}")
    for f in ("place", "inv"):
        np.testing.assert_array_equal(getattr(jpg, f), getattr(tpg, f),
                                      err_msg=f"{where}: {f}")
    assert (jpg.e_chunk, jpg.v_chunk, jpg.edge_mode, jpg.sorted_adj) == \
        (tpg.e_chunk, tpg.v_chunk, tpg.edge_mode, tpg.sorted_adj), where


def random_plan(pg, seed: int, n_pairs: int = 8, mod=jp):
    """tests/test_place.py's deterministic random plan, as ``mod``'s
    MigrationPlan."""
    rng = np.random.default_rng(seed)
    n = min(n_pairs, len(pg.inv) // 2)
    slots = rng.choice(len(pg.inv), 2 * n, replace=False)
    return mod.MigrationPlan(pairs=slots.reshape(n, 2).astype(np.int64))


def port_plan(plan):
    return tp.MigrationPlan(pairs=plan.pairs.copy(), reason=plan.reason)


def assert_plans_equal(jplan, tplan, where):
    np.testing.assert_array_equal(jplan.pairs, tplan.pairs, err_msg=where)
    assert tplan.pairs.dtype == np.int64, where
    assert jplan.reason == tplan.reason, where


def root_of(g):
    return int(np.argmax(g.ptr[1:] - g.ptr[:-1]))


# --------------------------------------------------------------------------
# Plans, pair for pair.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("part", sorted(PARTITIONS))
def test_plan_inputs_equal_reference(graph, padded, part):
    scheme, dies, pad = PARTITIONS[part]
    jpg, tpg = both(padded if pad else graph, scheme, dies)
    assert (jpg.inv < 0).any() == pad
    for a, b in zip(jp.placed_edges(jpg), tp.placed_edges(tpg)):
        assert b.dtype == np.int64
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jp.indegree_mass(jpg),
                                  tp.indegree_mass(tpg))
    td = tile_die_map(T, 0, *(dies or (2, 1)))
    aff = tp.vertex_die_affinity(tpg, td)
    assert aff.dtype == np.int64
    np.testing.assert_array_equal(jp.vertex_die_affinity(jpg, td), aff)


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("part", sorted(PARTITIONS))
def test_migration_plan_equals_reference(graph, padded, part, budget):
    """Every busy vector at this budget: the same pairs and reasons."""
    scheme, dies, pad = PARTITIONS[part]
    jpg, tpg = both(padded if pad else graph, scheme, dies)
    td = tile_die_of(dies)
    for name, seed in BUSY.items():
        busy = (seed if not isinstance(seed, int)
                else np.random.default_rng(seed).uniform(1.0, 100.0, T))
        jplan = jp.migration_plan(jpg, busy, budget=budget, tile_die=td)
        tplan = tp.migration_plan(tpg, busy, budget=budget, tile_die=td)
        assert_plans_equal(jplan, tplan, f"{part} busy {name}")
        assert tplan.moved_vertices(tpg) == jplan.moved_vertices(jpg) \
            <= budget
    if budget and dies is not None:   # the die phase really planned
        assert "die" in tplan.reason


def test_validate_plan_raises_as_reference(graph):
    jpg, tpg = both(graph)
    tp.validate_plan(tpg, port_plan(random_plan(jpg, 0)))
    tp.validate_plan(tpg, tp.empty_plan())
    bad = {"disjoint": [[0, 1], [1, 2]], "self-swap": [[3, 3]],
           "range": [[0, len(jpg.inv)]], "negative": [[-1, 2]],
           "shape": [[0, 1, 2]]}
    for name, pairs in bad.items():
        pairs = np.array(pairs, np.int64)
        with pytest.raises(ValueError) as want:
            jp.validate_plan(jpg, jp.MigrationPlan(pairs=pairs))
        with pytest.raises(ValueError) as got:
            tp.validate_plan(tpg, tp.MigrationPlan(pairs=pairs))
        assert str(got.value) == str(want.value), name


# --------------------------------------------------------------------------
# Partitions, array for array; the migrator's helpers.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("edge_mode", ["equal_edges", "vertex_aligned",
                                       "die_aligned"])
def test_apply_plan_equals_reference(graph, edge_mode):
    """A random plan and a planned one (which moves vertices across dies,
    so the die-aligned ``e_chunk`` changes with it)."""
    dies = (2, 2) if edge_mode == "die_aligned" else None
    td = tile_die_of(dies)
    jpg, tpg = both(graph, "low_order", dies, edge_mode)
    plans = [random_plan(jpg, 5)]
    if td is not None:
        plans.append(jp.migration_plan(jpg, None, budget=32, tile_die=td))
    chunks = {jpg.e_chunk}
    for i, jplan in enumerate(plans):
        j2 = jp.apply_plan(graph, jpg, jplan, tile_die=td)
        t2 = tp.apply_plan(graph, tpg, port_plan(jplan), tile_die=td)
        assert t2.device == tpg.device
        assert_partitions_equal(j2, t2, f"{edge_mode} plan {i}")
        chunks.add(t2.e_chunk)
    if td is not None:
        assert len(chunks) > 1, chunks


def test_apply_plan_keeps_sorted_adjacency(gsym):
    jpg = ja.prepare_triangles(gsym, T)
    tpg = ta.prepare_triangles(gsym, T, device="cpu")
    assert_partitions_equal(jpg, tpg, "triangles")
    jplan = random_plan(jpg, seed=7, n_pairs=4)
    j2 = jp.apply_plan(gsym, jpg, jplan)
    t2 = tp.apply_plan(gsym, tpg, port_plan(jplan))
    assert t2.sorted_adj and t2.edge_mode == "vertex_aligned"
    assert_partitions_equal(j2, t2, "triangles migrated")


def test_migrator_helpers_equal_reference(graph):
    jpg, tpg = both(graph, "low_order_dielocal", (2, 2))
    td = tile_die_of((2, 2))
    for seed in (0, 1, 2):
        jplan = random_plan(jpg, seed)
        tplan = port_plan(jplan)
        np.testing.assert_array_equal(
            jp.swap_permutation(len(jpg.inv), jplan.pairs),
            tp.swap_permutation(len(tpg.inv), tplan.pairs))
        for tdie in (None, td):
            assert tp.migration_words(tpg, tplan, tdie) == \
                jp.migration_words(jpg, jplan, tdie)
        j2 = jp.apply_plan(graph, jpg, jplan, tile_die=td)
        t2 = tp.apply_plan(graph, tpg, tplan, tile_die=td)
        arr = np.where(jpg.inv >= 0, np.random.default_rng(seed).normal(
            size=len(jpg.inv)), 0.0).astype(np.float32).reshape(T, -1)
        want = jp.remap_state(jpg, j2, arr)
        for given_arr in (arr, torch.from_numpy(arr)):
            got = tp.remap_state(tpg, t2, given_arr)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    assert tp.migration_words(tpg, tp.empty_plan(), td) == (0, 0)
    assert tp.swap_permutation(4, np.zeros((0, 2), np.int64)).tolist() == \
        [0, 1, 2, 3]


# --------------------------------------------------------------------------
# Pricing: the Stats' bits and the perf model's host functions.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fabric", ["ideal", "hier"])
def test_price_migration_and_perf_oracles_equal_reference(graph, fabric):
    """BFS on a migrated partition: the port's run == the JAX run, then
    priced by each package: every Stats field the reference's bits (and
    twice, so the adds start from a non-zero migration total)."""
    kw = dict(SMALL, **(HIER if fabric == "hier" else {}))
    dies = (2, 2) if fabric == "hier" else None
    scheme = "low_order_dielocal" if dies else "low_order"
    td = tile_die_of(dies)
    jpg, tpg = both(graph, scheme, dies)
    jplan = random_plan(jpg, seed=8)
    tplan = port_plan(jplan)
    jres = ja.bfs(jp.apply_plan(graph, jpg, jplan, tile_die=td),
                  root_of(graph), JConfig(backend="xla", **kw))
    tres = ta.bfs(tp.apply_plan(graph, tpg, tplan, tile_die=td),
                  root_of(graph), TConfig(**kw))
    np.testing.assert_array_equal(jres.values, tres.values)
    assert_stats_equal(jres.stats, tres.stats, "migrated run")
    jcfg, tcfg = JConfig(backend="xla", **kw), TConfig(**kw)
    js, ts = jres.stats, tres.stats
    for _ in range(2):
        js = jp.price_migration(js, jpg, jplan, T, params=jcfg.perf,
                                tile_die=td)
        ts = tp.price_migration(ts, tpg, tplan, T, params=tcfg.perf,
                                tile_die=td)
        assert_stats_equal(js, ts, "priced")
    assert int(ts.migrated_vertices) == 2 * tplan.moved_vertices(tpg) > 0
    assert float(ts.migration_cycles) > 0
    jnet, tnet = jmake_network(jcfg, T), make_network(tcfg, T)
    want = jmodel.energy_from_totals(js, jcfg.perf, jnet, T)
    got = tmodel.energy_from_totals(ts, tcfg.perf, tnet, T)
    assert isinstance(got, float)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    np.testing.assert_allclose(float(ts.energy_pj), got, rtol=1e-5)
    assert tmodel.flits_by_class(ts, tnet) == \
        jmodel.flits_by_class(js, jnet)
    frac = tmodel.die_crossing_frac(ts)
    np.testing.assert_allclose(frac, jmodel.die_crossing_frac(js),
                               rtol=1e-12)
    assert (frac > 0) == (fabric == "hier")
    words = tp.migration_words(tpg, tplan, td)
    assert tmodel.migration_cost(tcfg.perf, *words) == \
        jmodel.migration_cost(jcfg.perf, *words)


# --------------------------------------------------------------------------
# Runs on migrated partitions.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backend,fuse", [("kernels", True),
                                          ("kernels", False),
                                          ("torch", False)])
def test_bfs_on_migrated_partition_equals_jax(graph, backend, fuse):
    """A plan from the run's own ring on the hier 2x2 die-local
    partition, applied; BFS on the new shape == the JAX run's."""
    kw = dict(SMALL, trace=True, trace_rounds=256, **HIER)
    td = tile_die_of((2, 2))
    jpg, tpg = both(graph, "low_order_dielocal", (2, 2))
    jcfg = JConfig(backend="xla", **kw)
    tcfg = TConfig(backend=backend, fuse=fuse, **kw)
    root = root_of(graph)
    j0, t0 = ja.bfs(jpg, root, jcfg), ta.bfs(tpg, root, tcfg)
    jplan = jp.plan_from_trace(jpg, dataclasses.replace(
        jcfg, adapt_budget=16), j0.trace)
    tplan = tp.plan_from_trace(tpg, dataclasses.replace(
        tcfg, adapt_budget=16), t0.trace)
    assert_plans_equal(jplan, tplan, "plan from the ring")
    assert tplan.num_pairs
    j1 = ja.bfs(jp.apply_plan(graph, jpg, jplan, tile_die=td), root, jcfg)
    t1 = ta.bfs(tp.apply_plan(graph, tpg, tplan, tile_die=td), root, tcfg)
    np.testing.assert_array_equal(j1.values, t1.values)
    np.testing.assert_array_equal(t1.values, t0.values)
    assert_stats_equal(j1.stats, t1.stats, f"{backend} fuse={fuse}")
    per_round = {("kernels", True): 3, ("kernels", False): 5}.get(
        (backend, fuse), 0)
    assert int(t1.stats.launches) == per_round * int(t1.stats.rounds)


def _pow2_degree_graph(g: CSRGraph) -> CSRGraph:
    """tests/test_place.py's dyadic instance: each vertex's out-edges
    trimmed to the largest power of two <= its degree."""
    deg = g.ptr[1:] - g.ptr[:-1]
    keep = np.zeros(g.num_edges, bool)
    for v in range(g.num_vertices):
        d = int(deg[v])
        if d:
            keep[g.ptr[v]:g.ptr[v] + (1 << (d.bit_length() - 1))] = True
    src = np.repeat(np.arange(g.num_vertices), deg)[keep]
    return CSRGraph.from_edges(g.num_vertices, src, g.dst[keep],
                               np.ones(int(keep.sum()), np.float32),
                               dedup=False)


# name: (dyadic graph?, placement, fabric, damping, iters, adapt_every)
PAGERANK_CASES = {
    "dyadic": (True, None, {}, 0.5, 3, 1),
    "general hier": (False, (2, 2), HIER, 0.85, 4, 2),
}


@pytest.mark.parametrize("case", sorted(PAGERANK_CASES))
def test_adaptive_pagerank_equals_jax(graph, case):
    dyadic, dies, fabric, damping, iters, every = PAGERANK_CASES[case]
    g = _pow2_degree_graph(graph) if dyadic else graph
    kw = dict(SMALL, adapt=True, adapt_every=every, adapt_budget=16,
              trace=True, trace_rounds=256, **fabric)
    scheme = "low_order_dielocal" if dies else "low_order"
    jpg, tpg = both(g, scheme, dies)
    jres, jfinal, jplans = jp.adaptive_pagerank(
        g, jpg, damping=damping, iters=iters,
        cfg=JConfig(backend="xla", **kw))
    tres, tfinal, tplans = tp.adaptive_pagerank(
        g, tpg, damping=damping, iters=iters, cfg=TConfig(**kw))
    assert tplans and len(tplans) == len(jplans)
    for i, (a, b) in enumerate(zip(jplans, tplans)):
        assert_plans_equal(a, b, f"plan {i}")
    assert_partitions_equal(jfinal, tfinal, "final partition")
    np.testing.assert_array_equal(jres.values, tres.values)
    assert_stats_equal(jres.stats, tres.stats, case)
    assert tres.epochs == iters and int(tres.stats.migrated_vertices) > 0
    if dyadic:   # bitwise the unmigrated run too (tests/test_place.py)
        twin = ta.pagerank(tpg, damping=damping, iters=iters,
                           cfg=TConfig(**dict(kw, adapt=False)))
        np.testing.assert_array_equal(tres.values, twin.values)
    if not torch.cuda.is_available():  # a mesh runs (test_torch_spmd.py),
        # and a "cuda" one without a GPU raises: no fallback to the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            tp.adaptive_pagerank(g, tpg, iters=1, cfg=TConfig(**kw),
                                 mesh=SimpleNamespace(
                                     device_type="cuda",
                                     mesh_dim_names=("x",)))


# --------------------------------------------------------------------------
# The static front end with between-batch adaptation.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("trace", [False, True])
def test_adaptive_static_serving_equals_reference(graph, trace):
    """6 BFS sources through 2 lanes (tests/test_place.py:379), a plan
    after every batch: records, migrated vertices and the batch clock
    bitwise the reference's; every query its solo run on the starting
    partition.  With the trace on the plans read the lane rings."""
    jpg, tpg = both(graph)
    deg = np.asarray(graph.ptr[1:] - graph.ptr[:-1])
    srcs = np.flatnonzero(deg > 0)[:6].tolist()
    kw = dict(SMALL, adapt=True, adapt_every=1, adapt_budget=16,
              trace=trace, trace_rounds=256)
    jfe = JFrontend(jpg, app="bfs", cfg=JConfig(backend="xla", **kw),
                    width=2, graph=graph)
    fe = Frontend(tpg, app="bfs", cfg=TConfig(**kw), width=2, graph=graph)
    jrep, rep = jfe.serve(srcs), fe.serve(srcs)
    assert rep.migrated_vertices == jrep.migrated_vertices > 0
    assert rep.total_cycles == jrep.total_cycles
    assert rep.total_energy_pj == jrep.total_energy_pj
    assert rep.row() == jrep.row()
    assert rep.row()["migrated_vertices"] == rep.migrated_vertices
    assert rep.drops == 0
    for a, b in zip(rep.records, jrep.records):
        assert (a.qid, a.source, a.enqueue_cycle, a.admit_cycle,
                a.complete_cycle, a.rounds, a.edges) == (
            b.qid, b.source, b.enqueue_cycle, b.admit_cycle,
            b.complete_cycle, b.rounds, b.edges)
        np.testing.assert_array_equal(a.values, b.values)
        np.testing.assert_array_equal(
            a.values, ta.bfs(tpg, a.source, TConfig(**SMALL)).values)
    assert not np.array_equal(fe.pg.place, tpg.place)
    np.testing.assert_array_equal(fe.pg.place, jfe.pg.place)


def test_adaptive_serving_guards_raise_as_reference(graph):
    jpg, tpg = both(graph)
    cases = (dict(), dict(policy="continuous", graph=graph))
    for kw in cases:
        with pytest.raises(ValueError) as want:
            JFrontend(jpg, app="bfs", cfg=JConfig(adapt=True, **SMALL),
                      width=2, **kw)
        with pytest.raises(ValueError) as got:
            Frontend(tpg, app="bfs", cfg=TConfig(adapt=True, **SMALL),
                     width=2, **kw)
        assert str(got.value) == str(want.value)


# --------------------------------------------------------------------------
# Hypothesis fuzz: plans against the reference's on drawn busy vectors.
# --------------------------------------------------------------------------

if HAVE_HYPOTHESIS:

    @settings(max_examples=8, deadline=None, derandomize=True)
    @given(seed=st.integers(0, 2**31 - 1), budget=st.integers(0, 256))
    def test_fuzz_plans_equal_reference(graph, seed, budget):
        jpg, tpg = both(graph, "low_order_dielocal", (2, 2))
        td = tile_die_of((2, 2))
        busy = np.random.default_rng(seed).uniform(0.0, 100.0, T)
        jplan = jp.migration_plan(jpg, busy, budget=budget, tile_die=td)
        tplan = tp.migration_plan(tpg, busy, budget=budget, tile_die=td)
        assert_plans_equal(jplan, tplan, f"seed {seed} budget {budget}")
