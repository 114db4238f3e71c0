"""SPMD on ``torch.distributed``: the port's mesh runs == its emulated
tiles == the JAX package's, bit for bit.

Each case spawns ``torch_spmd_ranks.WORLD`` = 4 processes (T = 4, one tile
a rank) that join a gloo group through a file store in ``tmp_path`` and
run the case's entry points with ``mesh=`` a CPU mesh
(``tests/torch_spmd_ranks.py``; the kernels backend takes its plain
versions on the CPU).  Meanwhile this process makes the same calls with
``mesh=None`` (:class:`~repro_torch.core.comm.LocalComm`) and the JAX
package's at the same T on the same inputs (``backend="xla"``,
``LocalComm``).  Every rank's result must equal the emulated run's and
the JAX run's: values, every Stats field but ``launches`` (``cycles``,
``energy_pj`` and ``flits_per_link`` included), the trace rings, the
serving lanes' batch clocks and the front end's records, and the plans
of the adaptive PageRank.  The cases are those of the JAX package's SPMD
tests (``test_spmd.py``, ``test_programs.py``, ``test_serve.py``,
``test_place.py``, ``test_trace.py``, ``test_memspace.py``,
``test_backend_pallas.py``), under the three port paths ("torch",
"kernels" unfused and fused).  The collectives of ``AxisComm`` and
``LaneAxisComm`` are held against ``LocalComm`` / ``LaneComm`` on int32,
flags and float32 (the float sums' tile order, signed zeros and NaN), and
``routed_embed`` on a (2, 2) mesh against the plain gather.  Each spawn
has its own time limit, so a rank that waits forever fails its case.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import place as jp
from repro.core.comm import shard_map_compat
from repro.core.embedding import _routed_lookup_local
from repro.launch import mesh as jmesh
from repro.core import algorithms as ja
from repro.core import reference as ref
from repro.core.engine import EngineConfig as JConfig
from repro.core.graph import CSRGraph as JCSR
from repro.place.plan import MigrationPlan as JPlan
from repro.serve import Frontend as JFrontend
from repro.serve import multi_source as jmulti
from repro_torch.core import algorithms as ta
from repro_torch.core.comm import mesh_axis
from repro_torch.kernels.engine import fused
from repro_torch.launch.mesh import (auto_mesh, make_production_mesh,
                                     rules_for)
from repro_torch.serve import multi_source
import torch_spmd_ranks as R
from test_torch_staging import (CHAIN, CLASSIC, launched, launches, shard,
                                state, template)
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

HERE = Path(__file__).resolve().parent
SPAWN_TIMEOUT = 120  # seconds a case's ranks may take, start-up included
ENGINE_CASES = ("apps torch", "apps unfused", "apps fused", "noc",
                "programs", "memspace trace", "serve", "place")


# --------------------------------------------------------------------------
# The ranks.
# --------------------------------------------------------------------------

def spawn(case: str, tmp_path: Path):
    """Start the case's ranks; returns ``(procs, deadline)``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(HERE.parent / "src"), str(HERE)]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    procs = []
    for r in range(R.WORLD):
        with open(tmp_path / f"rank{r}.log", "wb") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(HERE / "torch_spmd_ranks.py"), case,
                 str(tmp_path), str(r), str(R.WORLD)],
                env=env, stdout=log, stderr=subprocess.STDOUT))
    return procs, time.monotonic() + SPAWN_TIMEOUT


def collect(case: str, tmp_path: Path, procs, deadline) -> list:
    """Wait for the ranks (killing all of them at the deadline) and load
    what each wrote."""
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        pytest.fail(f"the ranks of {case!r} did not end within "
                    f"{SPAWN_TIMEOUT} s")
    for r, p in enumerate(procs):
        log = (tmp_path / f"rank{r}.log").read_text(errors="replace")
        assert p.returncode == 0, f"rank {r} of {case!r}:\n{log[-4000:]}"
    name = case.replace(" ", "-")
    return [pickle.loads((tmp_path / f"{name}.rank{r}.pkl").read_bytes())
            for r in range(R.WORLD)]


# --------------------------------------------------------------------------
# Bitwise comparison of the numpy trees.
# --------------------------------------------------------------------------

def bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_same(want, got, where):
    """Two results, field for field and bit for bit, but ``launches``
    (each rank counts its own)."""
    if isinstance(want, dict):
        assert want.keys() == got.keys(), (where, want.keys(), got.keys())
        for k in want:
            if k != "launches":
                assert_same(want[k], got[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(want) == len(got), where
        for i, (a, b) in enumerate(zip(want, got)):
            assert_same(a, b, f"{where}[{i}]")
    elif want is None or got is None:
        assert want is None and got is None, where
    else:
        a, b = np.asarray(want), np.asarray(got)
        if a.ndim == 0 and b.ndim == 0:
            assert a.item() == b.item(), (where, a, b)
            return
        assert a.shape == b.shape and a.dtype == b.dtype, (
            where, a.shape, a.dtype, b.shape, b.dtype)
        np.testing.assert_array_equal(bits(a), bits(b), err_msg=where)


# --------------------------------------------------------------------------
# The JAX package's runs on the same inputs (T = 4, LocalComm).
# --------------------------------------------------------------------------

def jhost(x):
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {f: jhost(v) for f, v in zip(x._fields, x)}
    if type(x).__module__.startswith("jax"):
        return np.asarray(x)
    return x


def jresult(res) -> dict:
    return {f.name: jhost(getattr(res, f.name))
            for f in dataclasses.fields(res)}


def jgraph(name):
    g = R.graph(name)
    return JCSR(g.ptr, g.dst, g.val)


def jcfg(knobs, **kw):
    return JConfig(backend="xla", **knobs, **kw)


def jax_runs(keys) -> dict:
    """The JAX package's run of each key (a run's name without its port
    path)."""
    g, jpg = jgraph("g"), ja.prepare(jgraph("g"), R.WORLD)
    gs = jgraph("sym")
    root, srcs = R.root(g), R.sources(g)
    trace = dict(trace=True, trace_rounds=64)

    def migrated():
        pg1 = jp.apply_plan(g, jpg, JPlan(pairs=R.plan(jpg).pairs))
        return jresult(ja.bfs(pg1, root, jcfg(R.SMALL)))

    def adaptive():
        gd = jgraph("dyadic")
        kw = dict(R.SMALL, adapt=True, adapt_every=1, adapt_budget=16,
                  trace=True, trace_rounds=256)
        res, final, plans = jp.adaptive_pagerank(
            gd, ja.prepare(gd, R.WORLD), damping=0.5, iters=3,
            cfg=jcfg(kw))
        return dict(jresult(res), plans=[p.pairs for p in plans],
                    place=np.asarray(final.place))

    runs = {
        "bfs": lambda: ja.bfs(jpg, root, jcfg(R.SMALL)),
        "sssp": lambda: ja.sssp(jpg, root, jcfg(R.SMALL)),
        "spmv": lambda: ja.spmv(jpg, R.spmv_x(g), jcfg(R.SMALL)),
        "pagerank": lambda: ja.pagerank(jpg, iters=2, cfg=jcfg(R.SMALL)),
        "bfs-bsp": lambda: ja.bfs(jpg, root, jcfg(R.SMALL, mode="bsp")),
        "mesh": lambda: ja.bfs(jpg, root, jcfg(R.SMALL, noc="mesh",
                                               link_cap=2, **trace)),
        "torus": lambda: ja.bfs(jpg, root, jcfg(R.SMALL, noc="torus",
                                                link_cap=2, **trace)),
        "wcc": lambda: ja.wcc(ja.prepare(gs, R.WORLD), jcfg(R.SMALL)),
        "kcore": lambda: ja.kcore(ja.prepare(gs, R.WORLD), 3,
                                  jcfg(R.PROGRAMS)),
        "triangles": lambda: ja.triangles(
            ja.prepare_triangles(gs, R.WORLD), jcfg(R.PROGRAMS)),
        "hbm": lambda: ja.bfs(jpg, root, jcfg(R.SMALL, edge_space="hbm")),
        "trace async": lambda: ja.bfs(jpg, root, jcfg(R.SMALL, **trace)),
        "trace bsp": lambda: ja.bfs(jpg, root, jcfg(R.SMALL, mode="bsp",
                                                    **trace)),
        "lanes": lambda: jmulti(jpg, "bfs", srcs, jcfg(R.SMALL, **trace)),
        "lanes sssp": lambda: jmulti(jpg, "sssp", srcs[:3], jcfg(R.SMALL)),
        "frontend": lambda: R.report(JFrontend(
            jpg, app="bfs", cfg=jcfg(R.SMALL), width=4).serve(srcs[:-1])),
        "migrated": migrated,
        "adaptive pagerank": adaptive,
    }
    out = {}
    for k in keys:
        res = runs[k]()
        out[k] = res if isinstance(res, dict) else jresult(res)
    return out


def jax_key(name: str) -> str:
    """A run's name without its port path ("kcore fused" -> "kcore")."""
    words = name.split()
    return " ".join(words[:-1]) if words[-1] in R.PATHS else name


def check_oracles(case: str, runs: dict):
    """The emulated runs against the reference's oracles."""
    g, gs = jgraph("g"), jgraph("sym")
    root = R.root(g)
    for name, res in runs.items():
        stats = res.get("stats")
        if stats is not None:
            assert (np.asarray(stats["drops"]) == 0).all(), (case, name)
        key = jax_key(name)
        if key in ("bfs", "bfs-bsp", "mesh", "torus", "hbm", "trace async",
                   "trace bsp"):
            np.testing.assert_array_equal(res["values"], ref.bfs_ref(g, root))
        elif key == "sssp":
            np.testing.assert_allclose(res["values"], ref.sssp_ref(g, root),
                                       rtol=1e-5)
        elif key == "spmv":  # the reference's tolerance
            np.testing.assert_allclose(res["values"],
                                       ref.spmv_ref(g, R.spmv_x(g)),
                                       rtol=2e-4, atol=1e-4)
        elif key == "kcore":
            np.testing.assert_array_equal(res["values"],
                                          ref.kcore_ref(gs, 3))
        elif key == "triangles":
            pgt = R.partition("sym", "triangles")
            np.testing.assert_array_equal(
                res["values"], ref.triangles_ref(gs, key=pgt.place))
        elif key == "wcc":
            np.testing.assert_array_equal(res["values"], ref.wcc_ref(gs))


# --------------------------------------------------------------------------
# The tests.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", ENGINE_CASES)
def test_spmd_equals_emulation_and_jax(case, tmp_path):
    procs, deadline = spawn(case, tmp_path)
    try:
        local = R.CASES[case](None)
        jax = jax_runs(sorted({jax_key(n) for n in local}))
    finally:
        ranks = collect(case, tmp_path, procs, deadline)
    check_oracles(case, local)
    for name, res in local.items():
        assert_same(jax[jax_key(name)], res, f"{case}: {name} port vs jax")
    for r, got in enumerate(ranks):
        assert_same(local, got, f"{case}: rank {r} vs the emulation")
    if case == "noc":  # the capped links spilled and replayed
        assert local["mesh fused"]["stats"]["spills"].sum() > 0
    if case == "place":
        assert local["adaptive pagerank"]["plans"]


def test_axis_comms_equal_the_emulation_and_routed_embed(tmp_path):
    """Every collective of AxisComm and LaneAxisComm on each rank's rows
    equals LocalComm's / LaneComm's on the whole tensor (int32, flags,
    float32 with a sum whose value depends on the tiles' order, signed
    zeros and NaN); ``routed_embed`` on a (2, 2) ("data", "model") mesh
    gives each process its block of the plain gather of the placed table
    with overflow 0, and on a (4, 1) mesh the JAX package's routed lookup
    of 6 ids of one row at capacity 2 (4 overflow to zero rows)."""
    procs, deadline = spawn("comm", tmp_path)
    ranks = collect("comm", tmp_path, procs, deadline)
    for dt in R.DTYPES:
        for lanes in (0, R.LANES):
            want = R.local_collectives(dt, lanes)
            key = f"{'lanes' if lanes else 'axis'} {dt}"
            for r, got in enumerate(ranks):
                for f in R.COLLECTIVES:
                    w = want[f] if f == "to_global" else \
                        want[f][R.my_rows(r, lanes)]
                    assert_same(w, got[key][f], f"{key} {f} rank {r}")
    tile_order = R.local_collectives("float32")["to_global"][5, 0]
    assert tile_order == np.float32(1.0)  # not 0.0 or 2.0: no ring order
    placed, table, ids = R.embed_inputs()
    M, B, S = R.EMBED["M"], R.EMBED["B"], R.EMBED["S"]
    nb, sb = B // (R.WORLD // M), S // M
    want = table[ids]
    assert (want == placed[(ids % M) * (R.EMBED["V"] // M)
                           + ids // M]).all()
    seen = set()
    for got in ranks:
        e = got["embed"]
        assert e["overflow"] == 0
        b, m = e["data"], e["model"]
        seen.add((b, m))
        np.testing.assert_array_equal(
            e["emb"], want[b * nb:(b + 1) * nb, m * sb:(m + 1) * sb])
    assert len(seen) == R.WORLD  # every block, once
    # the overflow counter against the JAX package's routed lookup at M = 1
    # and capacity 2: 4 of 6 ids overflow and get zero rows
    table, ids = R.overflow_inputs()
    emb, ovf = jax.jit(shard_map_compat(
        lambda t, i: _routed_lookup_local(t, i, capacity=2, axis="model",
                                          M=1),
        mesh=jmesh.auto_mesh((1,), ("model",)),
        in_specs=(P(None, None), P(None)), out_specs=(P(None, None), P())))(
        jnp.asarray(table), jnp.asarray(ids[0], jnp.int32))
    assert int(ovf) == 4
    for got in ranks:
        assert got["overflow"]["overflow"] == int(ovf)
        np.testing.assert_array_equal(got["overflow"]["emb"][0],
                                      np.asarray(emb))


class _OneTileMesh:
    """A stand-in for a DeviceMesh of ``size`` processes on each of its
    axes ``names``, this process at coordinate 0."""

    def __init__(self, device_type, size, names=("x",)):
        self.device_type, self.mesh_dim_names = device_type, names
        self._size = size

    def get_group(self, axis):
        return None

    def size(self, dim):
        return self._size

    def get_local_rank(self, axis):
        return 0


def test_spmd_entry_points_refuse_a_missing_gpu_and_a_tile_count(
        monkeypatch):
    """A "cuda" mesh without a GPU raises (nothing falls back to gloo or
    the CPU); a mesh axis whose size is not the partition's T raises
    before any collective."""
    pg = R.partition("g")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        auto_mesh((1,), ("x",))
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh_axis(_OneTileMesh("cuda", R.WORLD), "x")
    cfg = R.cfg_of(R.SMALL, "fused")
    for run in (lambda m: ta.bfs(pg, 0, cfg, mesh=m),
                lambda m: multi_source(pg, "bfs", [0], cfg, mesh=m)):
        with pytest.raises(RuntimeError, match="CUDA"):
            run(_OneTileMesh("cuda", R.WORLD))
        with pytest.raises(ValueError, match="one tile a process"):
            run(_OneTileMesh("cpu", 2))


def test_mesh_helpers_refuse_what_they_cannot_build(monkeypatch):
    """The production mesh needs its 256 (512) processes; the rule tables
    are still to port and say so; a mesh is "cuda" or "cpu"."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    for multi in (False, True):
        with pytest.raises(ValueError, match="processes"):
            make_production_mesh(multi_pod=multi)
    for names in (("data", "model"), ("pod", "data", "model")):
        with pytest.raises(NotImplementedError, match="LM substrate"):
            rules_for(_OneTileMesh("cpu", 1, names))
    with pytest.raises(ValueError, match="device_type"):
        auto_mesh((1,), ("x",), device_type="tpu")


@pytest.mark.parametrize("leg", ["fused_leg0", "fused_tri_leg0"])
@pytest.mark.parametrize("rows,tile0", [(1, 3), (3, 2), (64, 0)])
def test_leg0_takes_the_tile_id_from_tile0(launches, leg, rows,  # noqa: F811
                                           tile0):
    """Leg 0's launch carries the template's ``tile0`` after the rows and
    the shard's tiles: one row over a one-row shard under AxisComm (tile0
    the rank), B rows of one tile under LaneAxisComm, every tile of the
    emulation (tile0 0); its placed-id payload is ``tile0 + row %
    shard_T`` (the card's check: chip_smoke.py phase spmd (a))."""
    Ts = 64 if rows == 64 else 1
    queues = CLASSIC if leg == "fused_leg0" else CHAIN
    getattr(fused, leg)(
        template(payload="value" if leg == "fused_leg0" else "placed",
                 pops=tuple(32 for _ in queues), tile0=tile0), None, None,
        shard(Ts, 4096, 9000), state(rows, 4096, queues))
    fn, args = launched(launches, fused.LIBRARY)
    ints = [a for a in args if isinstance(a, int)]
    assert ints[:3] == [rows, Ts, tile0], (fn, ints[:3])
