"""The port's flight recorder (``repro_torch.trace``) against the JAX
package's.

* The port's ring against the JAX ring (``backend="xla"``), bitwise on
  every field but ``launches`` (the cursor as a number), async and BSP,
  on the ideal crossbar and on ``hier`` 2x2: the port's ``"torch"`` and
  ``"kernels"`` unfused and fused paths.  ``launches`` holds the port's
  own per-round tally (0, 5 and 3).
* Trace on against trace off: values and every Stats field bitwise.
* Ring semantics, port only: a wrapped ring holds the last R recorded
  rounds of the full ring, ``trace_every > 1`` records every k-th round,
  ``trace_every > trace_rounds`` too.
* The Perfetto, JSONL and summary exports and the cycle reconciliation
  of the port's ring equal the reference's of the JAX ring; the CLI runs
  a hier preset end to end on the CPU.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core import algorithms as ja
from repro.core.engine import EngineConfig as JConfig
from repro.core.graph import CSRGraph, rmat_edges
from repro.trace import export as jexp
from repro_torch.core import algorithms as ta
from repro_torch.core.engine import EngineConfig as TConfig
from repro_torch.trace import export as texp
from repro_torch.trace import SERIES_FIELDS, TraceBuf
from repro_torch.core.program import BFS, as_program, sized_cfg
from repro_torch.trace.__main__ import main as trace_main
from test_torch_engine import assert_stats_equal, port_partition
from test_torch_noc import PORT_PATHS
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

# the knobs of tests/test_trace.py's small_cfg
SMALL_TRACE = dict(f_pop=8, r_pop=8, u_pop=16, max_t2=8, cap_route_range=8,
                   cap_route_update=32, cap_rangeq=128, cap_updq=4096,
                   max_rounds=5000)
FABRICS = {"ideal": {}, "hier": dict(noc="hier", ndies_y=2, ndies_x=2)}
LAUNCHES = {("torch", False): 0, ("kernels", False): 5,
            ("kernels", True): 3}


@pytest.fixture(scope="module")
def graph():
    n, src, dst, val = rmat_edges(7, edge_factor=5, seed=3)
    return CSRGraph.from_edges(n, src, dst, val)


@pytest.fixture(scope="module")
def pgs(graph):
    jpg = ja.prepare(graph, T=8)
    return jpg, port_partition(jpg)


def root_of(g):
    return int(np.argmax(g.ptr[1:] - g.ptr[:-1]))


def knobs(fabric, mode="async", **kw):
    return dict(SMALL_TRACE, mode=mode, **FABRICS[fabric], **kw)


_JAX_RUNS = {}


def jax_run(graph, pgs, fabric, mode):
    """The JAX package's traced BFS (one per fabric and mode a session)."""
    key = (fabric, mode)
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = ja.bfs(pgs[0], root_of(graph), JConfig(
            backend="xla", trace=True, trace_rounds=256,
            **knobs(fabric, mode)))
    return _JAX_RUNS[key]


def port_run(graph, pgs, backend="torch", fuse=False, **kw):
    return ta.bfs(pgs[1], root_of(graph),
                  TConfig(backend=backend, fuse=fuse, **kw))


def bits(a):
    a = texp.host(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_rings_equal(want, got, where, launches=True):
    """Two rings bitwise, field for field (``cursor`` as a number)."""
    assert int(texp.host(want.cursor)) == int(got.cursor), where
    for f in TraceBuf._fields[1:]:
        if f == "launches" and not launches:
            continue
        w, g = texp.host(getattr(want, f)), texp.host(getattr(got, f))
        assert w.shape == g.shape and w.dtype == g.dtype, (where, f)
        np.testing.assert_array_equal(bits(w), bits(g),
                                      err_msg=f"{where}: {f}")


# --------------------------------------------------------------------------
# The ring against the JAX package's, and trace on against off.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["async", "bsp"])
@pytest.mark.parametrize("fabric", sorted(FABRICS))
def test_ring_bitwise_equals_jax(graph, pgs, fabric, mode):
    want = jax_run(graph, pgs, fabric, mode)
    off = port_run(graph, pgs, **knobs(fabric, mode))
    assert off.trace is None
    for backend, fuse in PORT_PATHS:
        got = port_run(graph, pgs, backend, fuse, trace=True,
                       trace_rounds=256, **knobs(fabric, mode))
        where = f"{fabric} {mode} {backend} fuse={fuse}"
        np.testing.assert_array_equal(want.values, got.values, err_msg=where)
        assert_stats_equal(want.stats, got.stats, where)
        # trace on == trace off, launches included
        np.testing.assert_array_equal(off.values, got.values)
        assert_stats_equal(off.stats, got.stats, where)
        if backend == "torch":
            assert torch.equal(off.stats.launches, got.stats.launches)
        assert_rings_equal(want.trace, got.trace, where, launches=False)
        n = int(got.stats.rounds)
        assert got.trace.cursor == n > 1
        assert (got.trace.launches[:n] == LAUNCHES[backend, fuse]).all()
        assert int(got.trace.launches.sum()) == int(got.stats.launches)
    tr = texp.trace_arrays(got.trace)
    np.testing.assert_array_equal(tr["msgs"].sum(0), got.stats.msgs.numpy())
    assert tr["link_cls"].sum() == int(got.stats.flits_per_link.sum())
    if fabric == "hier":
        assert tr["link_cls"][:, 4].sum() > 0  # DIE-class flits recorded


def test_ring_series_fields_match_reference():
    from repro.trace.buffer import SERIES_FIELDS as JFIELDS
    from repro.trace.buffer import TraceBuf as JBuf
    assert SERIES_FIELDS == JFIELDS and TraceBuf._fields == JBuf._fields


# --------------------------------------------------------------------------
# Ring semantics (port only): every round's slot against the full ring.
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def full(graph, pgs):
    """The ring that holds every round, kernels fused."""
    return port_run(graph, pgs, "kernels", True, trace=True,
                    trace_rounds=1024, **knobs("ideal"))


def rows_of(res, rounds):
    """The full ring's slots of the engine rounds ``rounds``, as a ring
    in record order."""
    ix = torch.as_tensor(np.asarray(rounds, np.int64))
    return TraceBuf(len(rounds), *(getattr(res.trace, f)[ix]
                                   for f in TraceBuf._fields[1:]))


@pytest.mark.parametrize("R,every", [(4, 1), (4, 2), (4, 8), (1024, 2),
                                     (1024, 3)])
def test_ring_cadence_and_wrap(graph, pgs, full, R, every):
    n = int(full.stats.rounds)
    assert 8 < n < 1024
    res = port_run(graph, pgs, "kernels", True, trace=True, trace_rounds=R,
                   trace_every=every, **knobs("ideal"))
    assert_stats_equal(full.stats, res.stats, f"R={R} every={every}")
    recorded = np.arange(0, n, every)
    tr = texp.trace_arrays(res.trace)
    assert res.trace.cursor == tr["n_seen"] == len(recorded)
    kept = recorded[-R:]
    assert tr["n_recorded"] == len(kept)
    np.testing.assert_array_equal(tr["round_id"], kept)
    want = texp.trace_arrays(rows_of(full, kept))
    for f in SERIES_FIELDS:
        np.testing.assert_array_equal(bits(want[f]), bits(tr[f]), err_msg=f)
    rec = texp.reconcile_cycles(res.trace, float(res.stats.cycles))
    # certified iff the ring did not wrap and holds the last round
    assert rec["exact"] == (len(recorded) <= R and kept[-1] == n - 1)
    if kept[-1] == n - 1:  # the last slot anchors the timeline's end
        assert rec["last_total"] == float(res.stats.cycles)


# --------------------------------------------------------------------------
# Exports against the reference's, and the CLI.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fabric", sorted(FABRICS))
def test_exports_equal_reference(graph, pgs, fabric, tmp_path):
    want = jax_run(graph, pgs, fabric, "async")
    got = port_run(graph, pgs, trace=True, trace_rounds=256,
                   **knobs(fabric))
    meta = {"app": "bfs", "noc": fabric}
    assert texp.to_perfetto(got.trace, meta) == jexp.to_perfetto(
        want.trace, meta)
    assert texp.jsonl_rows(got.trace) == jexp.jsonl_rows(want.trace)
    assert texp.summarize(got.trace) == jexp.summarize(want.trace)
    assert texp.format_summary(texp.summarize(got.trace)) == \
        jexp.format_summary(jexp.summarize(want.trace))
    assert texp.trace_metrics(got.trace) == jexp.trace_metrics(want.trace)
    cycles = float(got.stats.cycles)
    assert texp.reconcile_cycles(got.trace, cycles) == \
        jexp.reconcile_cycles(want.trace, cycles)
    assert texp.reconcile_cycles(got.trace, cycles)["exact"]
    for name, write in (("perfetto.json", texp.write_perfetto),
                        ("jsonl", texp.write_jsonl)):
        write(got.trace, str(tmp_path / f"port.{name}"))
        getattr(jexp, write.__name__)(want.trace,
                                      str(tmp_path / f"jax.{name}"))
        assert (tmp_path / f"port.{name}").read_text() == \
            (tmp_path / f"jax.{name}").read_text()


def test_trace_cli_runs_a_hier_preset(tmp_path, capsys):
    out, jl = tmp_path / "bfs.perfetto.json", tmp_path / "bfs.jsonl"
    rc = trace_main(["export", "--preset", "rmat-hier", "--scale", "6",
                     "--tiles", "16", "--device", "cpu", "--backend",
                     "kernels", "--out", str(out), "--jsonl", str(jl)])
    text = capsys.readouterr().out
    assert rc == 0, text
    assert "noc=hier" in text and "exact=True" in text
    doc = json.loads(out.read_text())
    assert doc["otherData"]["placement"] == "low_order_dielocal"
    rows = [json.loads(line) for line in jl.read_text().splitlines()]
    assert rows and all(r["launches"] == 3 for r in rows)
    assert any("die" in r["link_cls"] for r in rows)
    assert trace_main(["summarize", "--preset", "rmat-small", "--scale",
                       "6", "--tiles", "4", "--noc", "torus", "--device",
                       "cpu", "--trace-rounds", "1"]) == 0
    assert "ring wrapped" in capsys.readouterr().out
    # the adapt preset, once refused, runs as the reference's CLI runs it
    # (without adapt, its queues sized): its figures and summary equal
    # the JAX package's run of the same config
    argv = ["summarize", "--preset", "rmat-hier-adapt", "--scale", "6",
            "--device", "cpu"]
    assert trace_main(argv) == 0
    text = capsys.readouterr().out
    assert "placement=low_order_dielocal" in text
    tcfg = sized_cfg(TConfig(noc="hier", ndies_y=2, ndies_x=2, trace=True,
                             trace_rounds=4096), as_program(BFS), 64)
    jcfg = JConfig(backend="xla", noc="hier", ndies_y=2, ndies_x=2,
                   trace=True, trace_rounds=4096, cap_rangeq=tcfg.cap_rangeq,
                   cap_updq=tcfg.cap_updq)
    n, src, dst, val = rmat_edges(6, edge_factor=10, seed=1)
    g = CSRGraph.from_edges(n, src, dst, val)
    jpg = ja.prepare(g, 64, scheme="low_order_dielocal", dies=(2, 2))
    jres = ja.bfs(jpg, root_of(g), jcfg)
    st = jres.stats
    assert (f"rounds={int(st.rounds)} cycles={float(st.cycles):.0f} "
            f"energy_pj={float(st.energy_pj):.0f}") in text
    assert jexp.format_summary(jexp.summarize(jres.trace)) in text


def test_trace_off_config_adds_no_ring(graph, pgs):
    res = port_run(graph, pgs, **knobs("hier"))
    assert res.trace is None
    cfg = dataclasses.replace(TConfig(), trace=True, trace_rounds=0)
    with pytest.raises(AssertionError, match="trace_rounds"):
        ta.bfs(pgs[1], root_of(graph), cfg)
