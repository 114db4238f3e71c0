"""The engine kernels past their shared-memory staging, and the scan and
wedge legs' in-place appends and live-row turns.

Every wrapper takes the engine configs that the reference serves, past
what its kernel stages in shared memory: the add folds over more than
16,384 received rows a tile (SpMV, PageRank, k-core and triangles at T =
257 under the default ``cap_route_update`` of 64), fused leg 0 and the
wedge leg over more than 256 popped rows, the wedge leg and
``queue_push_pop`` over more than 8,192 fresh rows, ``scatter_segments``
over more than 16,384 updates a bin, and the streamed scan at a window
above 2,048.  There each kernel takes a second path with the same bits
(``path`` on the wrapper names it).

This file imports no JAX, so the card's machine runs it:
``python -m pytest -q -m cuda tests/test_torch_staging.py``.  Anywhere:
every wrapper accepts those configs, with the launch recorded instead of
made, and names its path.  On the card (``cuda``): each path held bitwise
against its plain version, the fused legs inside engine runs by the legs'
contract (``fused.contract``: queues below their counts, valid message
rows; the popped rows past the pop 0), at shapes past the thresholds that
the kernels are compiled with; the runs' values and Stats bitwise equal to
the ``"torch"`` backend's.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import algorithms as alg
from repro_torch.core.engine import EngineConfig, EngineState, GraphShard
from repro_torch.core.graph import CSRGraph, rmat_edges
from repro_torch.core.queues import Queue
from repro_torch.kernels.engine import fused
from repro_torch.kernels.engine import kernel
from repro_torch.kernels.engine import launches as launch_records
from repro_torch.kernels.engine.fused import LegTemplate
from repro_torch.kernels.engine.kernel import column_split
from repro_torch.kernels.scatter_update import kernel as seg
from repro_torch.kernels.scatter_update import (binned_scatter,
                                                scatter_segments)
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

H100_SMS = 132
F32, I32, BOOL = torch.float32, torch.int32, torch.bool


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def assert_same(got, want, where):
    """Every tensor of two lists bitwise equal."""
    assert len(got) == len(want), where
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.dtype == b.dtype, (where, i)
        assert torch.equal(bits(a), bits(b)), (where, i)


# --------------------------------------------------------------------------
# Anywhere: the CUDA branch of every wrapper, the launch recorded
# --------------------------------------------------------------------------

@pytest.fixture
def launches(monkeypatch):
    """Every wrapper's CUDA branch on meta tensors, its launch recorded
    instead of made: a list of (launcher, args).  The column split is the
    H100's (132 SMs)."""
    calls = []

    def record(fn, *args):
        calls.append((fn, args))

    split = lambda nb, b, dev: column_split(nb, b, H100_SMS)  # noqa: E731
    monkeypatch.setattr(fused, "_on_cpu", lambda st: False)
    for mod, name in ((fused, "_check"), (kernel, "_check"),
                      (seg, "check")):
        monkeypatch.setattr(mod, name, lambda *operands: None)
    monkeypatch.setattr(fused, "_launch", record)
    monkeypatch.setattr(kernel, "_launch", record)
    monkeypatch.setattr(seg.LIBRARY, "launch", record)
    for mod in (fused, kernel, seg):
        monkeypatch.setattr(mod, "device_split", split)
    for w in (*fused.KERNELS, *kernel.KERNELS, scatter_segments):
        monkeypatch.setattr(w, "launches", w.launches)
    for w in (*fused.KERNELS, kernel.queue_push_pop,
              kernel.fold_scatter_add, scatter_segments):
        monkeypatch.setattr(w, "path", w.path)
    return calls


def launched(calls, library):
    """The one recorded launch: its name and arguments, each of its C
    type (a pointer: a tensor, or None for a null one)."""
    (fn, args), = calls
    types = library.signatures[fn][:-1]  # the stream comes last
    assert len(args) == len(types), fn
    for a, ty in zip(args, types):
        want = (torch.Tensor, type(None)) if ty is fused._P else int
        assert isinstance(a, want), (fn, a, ty)
    calls.clear()
    return fn, args


def meta(*shape, dtype=I32):
    return torch.empty(shape, dtype=dtype, device="meta")


def state(T, v_chunk, queues):
    """An EngineState of meta tensors; ``queues``: (cap, width) each."""
    return EngineState(
        value=meta(T, v_chunk, dtype=F32), acc=meta(T, v_chunk, dtype=F32),
        frontier=meta(T, v_chunk, dtype=BOOL),
        next_frontier=meta(T, v_chunk, dtype=BOOL),
        queues=tuple(Queue(meta(T, cap, w), meta(T)) for cap, w in queues),
        net_pressure=meta(T))


def shard(T, v_chunk, e_chunk):
    return GraphShard(meta(T, v_chunk), meta(T, v_chunk), meta(T, e_chunk),
                      meta(T, e_chunk, dtype=F32))


def template(**kw):
    base = dict(payload="value", emit="plus1", fold="min", k=0,
                mode="async", policy="traffic", window=0, f_pop=32,
                pops=(32, 64), max_t2=32, plimit=64)
    base.update(kw)
    return LegTemplate(**base)


def messages(T, R, w):
    return meta(T, R, w), meta(T, R, dtype=BOOL)


CLASSIC = ((2048, 3), (16384, 2))
CHAIN = ((2048, 3), (16384, 2), (4096, 4), (16384, 2))
T257, R257 = 257, 257 * 64   # T = 257 at the default cap_route_update


@pytest.mark.parametrize("leg", ["fold_scatter_add", "fused_leg2",
                                 "fused_kcore_leg2", "fused_tri_leg4",
                                 "scatter_segments"])
def test_add_folds_take_rows_past_the_sort_buffer(launches, leg):
    """The add folds at T = 257 with the default cap_route_update (16,448
    received rows a tile), and scatter_segments at 16,385 updates a bin,
    launch in chunks of FOLD_ADD_MAX_ROWS rows (path: 2 chunks) instead of
    raising; at 16,384 rows, one chunk.  The close leg sorts nothing: it
    launches at both row counts on its one path (slot counts)."""
    sizes = ((16385 if leg == "scatter_segments" else R257, "2 chunks"),
             (16384, "one chunk"))
    for R, path in sizes:
        if leg == "fold_scatter_add":
            kernel.fold_scatter_add(meta(T257, 4, dtype=F32), meta(T257, R),
                                    meta(T257, R, dtype=F32),
                                    meta(T257, R, dtype=BOOL))
            wrapper, lib = kernel.fold_scatter_add, kernel.LIBRARY
        elif leg == "scatter_segments":
            scatter_segments(meta(64, 65536, dtype=F32), meta(64, R),
                             meta(64, R, dtype=F32), op="add")
            wrapper, lib = scatter_segments, seg.LIBRARY
        else:
            wrapper, lib = getattr(fused, leg), fused.LIBRARY
            fold = {"fused_leg2": "add", "fused_kcore_leg2": "kcore",
                    "fused_tri_leg4": "add"}[leg]
            queues = CHAIN if leg == "fused_tri_leg4" else CLASSIC
            wrapper(template(fold=fold, k=5), None, None,
                    shard(T257, 4, 32), state(T257, 4, queues),
                    *messages(T257, R, 2), *messages(T257, 64, 2))
        fn, args = launched(launches, lib)
        ints = [a for a in args if isinstance(a, int)]
        assert kernel.FOLD_ADD_MAX_ROWS == 16384
        assert R in ints, (fn, ints)
        if leg == "fused_tri_leg4":
            path = fused.CLOSE_PATH
        assert wrapper.path == path, (leg, R, wrapper.path)


@pytest.mark.parametrize("leg", ["fused_leg0", "fused_tri_leg0"])
def test_leg0_stages_its_pops_past_256_rows(launches, leg):
    """Leg 0 takes f_pop = r_pop = 512 (dynamic shared memory), and a
    staging past STAGE_SMEM_MAX bytes in a device-memory scratch of that
    many bytes a tile."""
    queues = CLASSIC if leg == "fused_leg0" else CHAIN
    wrapper = getattr(fused, leg)
    payload = "value" if leg == "fused_leg0" else "placed"
    T = 16
    for f_pop, path in ((512, "shared memory"), (8192, "device scratch")):
        pops = (f_pop,) + tuple(64 for _ in queues[1:])
        cap = max(2 * f_pop, 2048)
        qs = ((cap, 3),) + queues[1:]
        wrapper(template(payload=payload, f_pop=f_pop, pops=pops), None,
                None, shard(T, 4096, 4096), state(T, 4096, qs))
        fn, args = launched(launches, fused.LIBRARY)
        nbytes = fused.leg0_stage_bytes(f_pop, f_pop)
        pointers = fused.LIBRARY.signatures[fn].count(fused._P) - 1
        scratch = args[pointers - 1]   # the last pointer before the ints
        assert args[-1] == nbytes, args
        assert (scratch is None if f_pop == 512
                else tuple(scratch.shape) == (T, nbytes))
        assert (nbytes <= kernel.STAGE_SMEM_MAX) == (f_pop == 512)
        assert wrapper.path == path


def test_wedge_leg_takes_512_pops_and_8193_fresh_rows(launches):
    """The wedge leg at r_pop = 512 over 16 x 520 = 8,320 delivered wedges
    (past the 8,192 fresh rows it took): staged in shared memory; at a
    pop past STAGE_SMEM_MAX bytes of staging, in the device scratch.  It
    appends onto the wedge queue in place, its grid (T, G + 2) the column
    split of its wedges."""
    T, R = 16, 16 * 520
    for r_pop, path in ((512, "shared memory"), (16384, "device scratch")):
        st = state(T, 4096, ((2048, 3), (16384, 2), (2 * r_pop, 4),
                             (16384, 2)))
        out = fused.fused_tri_leg2(
            template(payload="placed", pops=(32, 64, r_pop, 64)), None,
            None, shard(T, 4096, 4096), st, *messages(T, R, 2),
            *messages(T, 64, 2), meta(T, 4))
        fn, args = launched(launches, fused.LIBRARY)
        nbytes = fused.wedge_stage_bytes(r_pop)
        assert args[-1] == nbytes
        scratch = args[21]   # the last of the 22 pointers
        assert (scratch is None if r_pop == 512
                else tuple(scratch.shape) == (T, nbytes))
        assert fused.fused_tri_leg2.path == path
        assert (nbytes <= kernel.STAGE_SMEM_MAX) == (r_pop == 512)
        ints = [a for a in args if isinstance(a, int)]
        assert ints[3] == R and ints[-2] == column_split(T, R, H100_SMS).G
        assert args[0] is st.queues[1].data          # appended in place
        assert out[0].queues[1].data is st.queues[1].data
        assert out[0].queues[2].data is not st.queues[2].data
        assert out[1].shape == (T, r_pop, 4)


@pytest.mark.parametrize("m,path", [(8193, "shared memory"),
                                    (16448, "shared memory"),
                                    (60000, "device scratch")])
def test_queue_push_pop_takes_more_fresh_rows(launches, m, path):
    """The unfused turn past 8,192 fresh rows: their indices (4 bytes
    each) in dynamic shared memory up to STAGE_SMEM_MAX, else in a scratch
    of m ints a tile."""
    T, cap = 8, 65536
    kernel.queue_push_pop(meta(T, cap, 4), meta(T), meta(T, m, 4),
                          meta(T, m, dtype=BOOL), meta(T), 32)
    fn, args = launched(launches, kernel.LIBRARY)
    scratch = args[10]
    assert args[-2:] == (m, 32)
    assert args[11:13] == (T, column_split(T, cap, H100_SMS).G)  # T, G
    assert (tuple(scratch.shape) == (T, 4 * m) if path == "device scratch"
            else scratch is None)
    assert kernel.queue_push_pop.path == path
    with pytest.raises(ValueError, match="2\\*\\*31"):  # the index guard
        kernel.queue_push_pop(meta(1, 2 ** 29, 4), meta(1), meta(1, 4, 4),
                              meta(1, 4, dtype=BOOL), meta(1), 4)


@pytest.mark.parametrize("window,path", [(2048, "staged window"),
                                         (4096, "device window"),
                                         (65536, "device window")])
def test_streamed_scans_take_any_window(launches, window, path):
    """edge_scan_stream and the streamed fused leg 1 take any window of at
    least max_t2 (the reference's resolve_window).  The standalone scan has
    one path at every window (it stages nothing: its own entry, the
    gather's scan); fused leg 1 stages up to STREAM_MAX_WINDOW and reads a
    wider window from device memory."""
    T, R = 16, 256
    st, stop = meta(T, R), meta(T, R)
    out = kernel.edge_scan_stream(meta(T, 9000), meta(T, 9000, dtype=F32),
                                  st, stop, meta(T, R, dtype=BOOL), 32,
                                  window)
    fn, args = launched(launches, kernel.LIBRARY)
    assert fn == "repro_edge_scan_stream"
    assert args[-5:] == (T, 9000, R, 32, window)
    assert all(a is b for a, b in zip(args[5:8], out))
    assert [tuple(x.shape) for x in out] == [(T, R, 32)] * 3
    assert not hasattr(kernel.edge_scan_stream, "path")
    fused.fused_leg1(template(window=window), None, None,
                     shard(T, 4096, 9000), state(T, 4096, CLASSIC),
                     *messages(T, R, 3), *messages(T, 32, 3), meta(T, 2))
    fn, args = launched(launches, fused.LIBRARY)
    assert args[-5] == window
    assert fused.fused_leg1.path == path
    with pytest.raises(ValueError, match="max_t2"):
        kernel.edge_scan_stream(meta(T, 9000), meta(T, 9000, dtype=F32),
                                st, stop, meta(T, R, dtype=BOOL), 32, 16)


def test_thresholds_are_the_kernels_compiled_constants():
    """kernel.py's thresholds are read from the headers that the kernels
    are compiled with; no wrapper passes one at run time."""
    assert (kernel.FOLD_ADD_MAX_ROWS, kernel.STREAM_MAX_WINDOW,
            kernel.STAGE_SMEM_MAX) == (16384, 2048, 204800)
    for header, name in ((kernel.ORDERED_SCATTER, "FOLD_ADD_MAX_ROWS"),
                         (kernel.ENGINE_DEVICE, "STREAM_MAX_WINDOW"),
                         (kernel.ENGINE_DEVICE, "STAGE_SMEM_MAX")):
        assert f"{name} = {getattr(kernel, name)};" in header.read_text()
    with pytest.raises(ValueError, match="NOT_THERE"):
        kernel._constant(kernel.ENGINE_DEVICE, "NOT_THERE")


@pytest.mark.parametrize("leg,chan", [("fused_leg1", 1),
                                      ("fused_tri_leg1", 1),
                                      ("fused_tri_leg3", 3)])
def test_scan_leg_appends_in_place_and_turns_into_a_new_queue(launches, leg,
                                                              chan):
    """The scan legs append the range spills onto the range queue they are
    given (the returned state shares its storage) and turn the spill-only
    queue into a new one; their grid is (T, G + 1) with G the column split
    of the R * max_t2 message lanes, and the G blocks' edge sums and
    tickets are the last two rows of the leg's counts, which the launch
    clears."""
    T, R = 64, 64 * 16
    queues = CLASSIC if leg == "fused_leg1" else CHAIN
    st = state(T, 4096, queues)
    w = queues[chan - 1][1]
    emit = {"fused_leg1": "plus1"}.get(leg, "")
    tmpl = template(emit=emit or "plus1", payload="placed" if emit == ""
                    else "value", pops=tuple(64 for _ in queues))
    out = getattr(fused, leg)(tmpl, None, None, shard(T, 4096, 9000), st,
                              *messages(T, R, w), *messages(T, 32, w),
                              meta(T, len(queues)))
    fn, args = launched(launches, fused.LIBRARY)
    rq, uq = st.queues[chan - 1], st.queues[chan]
    assert args[0] is rq.data
    assert out[0].queues[chan - 1].data is rq.data
    assert out[0].queues[chan].data is not uq.data
    assert out[0].queues[chan].data.shape == uq.data.shape
    G = [a for a in args if isinstance(a, int)][-1]
    assert G == column_split(T, R * 32, H100_SMS).G == 5
    tally, counts = args[21], args[11]._base
    assert tally._base is counts and tuple(counts.shape) == (9, T)
    assert tuple(tally.shape) == (2, T)
    assert tally.storage_offset() == 7 * T
    assert out[1].shape == (T, 64 + R * 32, 2)
    assert fused.IN_PLACE[leg] == chan - 1 and fused.LIVE_TURN[leg] == chan


def test_contract_splits_defined_and_dont_care_rows():
    """``fused.contract``: a queue's rows from its count on and the popped
    message rows past the pop are out of the defined part; a change there
    leaves it equal, one anywhere else does not."""
    T, cap, eff, R, mt = 2, 8, 4, 3, 2
    tmpl = template(pops=(4, eff), max_t2=mt)
    rq = Queue(torch.arange(T * 16 * 3, dtype=I32).reshape(T, 16, 3),
               torch.tensor([3, 0], dtype=I32))
    uq = Queue(torch.arange(T * cap * 2, dtype=I32).reshape(T, cap, 2),
               torch.tensor([5, 2], dtype=I32))
    z = torch.zeros((T, 4))
    st = EngineState(z, z, z.bool(), z.bool(), (rq, uq),
                     torch.zeros(T, dtype=I32))
    n = eff + R * mt
    msgs = torch.arange(T * n * 2, dtype=I32).reshape(T, n, 2)
    mvalid = torch.zeros((T, n), dtype=BOOL)
    mvalid[:, :2] = True
    mvalid[0, eff + 1] = True
    counts = [torch.ones(T, dtype=I32)] * 5
    out = (st, msgs, mvalid, *counts)
    ref, past = fused.contract("fused_leg1", tmpl, st, out)
    assert past.shape == (2 * (eff - 2), 2)

    def changed(f):
        q, m, v = uq.data.clone(), msgs.clone(), mvalid.clone()
        f(q, m, v)
        st2 = st._replace(queues=(rq, Queue(q, uq.count)))
        return fused.contract("fused_leg1", tmpl, st, (st2, m, v,
                                                       *counts))[0]

    def same(a, b):
        return len(a) == len(b) and all(torch.equal(x, y)
                                        for x, y in zip(a, b))

    def set_(t, idx, val):
        t[idx] = val

    assert same(ref, changed(lambda q, m, v: set_(q, (0, 5), -1)))
    assert same(ref, changed(lambda q, m, v: set_(m, (1, 3), 0)))
    assert not same(ref, changed(lambda q, m, v: set_(q, (0, 4), -1)))
    assert not same(ref, changed(lambda q, m, v: set_(m, (1, 1), 0)))
    assert not same(ref, changed(lambda q, m, v: set_(m, (1, eff), -1)))
    assert not same(ref, changed(lambda q, m, v: set_(v, (1, 3), True)))


# --------------------------------------------------------------------------
# On the card: the kernels at the past-staging shapes
# --------------------------------------------------------------------------

def rng_on(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("T,v_chunk,R", [(2, 64, 40000), (257, 4, R257),
                                         (3, 4096, 16385), (1, 64, 100000)])
def test_fold_scatter_add_kernel_in_chunks(T, v_chunk, R):
    """The add fold past 16,384 rows a tile (duplicates across chunks, T
    = 257 at the default cap_route_update, and 7 chunks), bitwise its plain
    version."""
    dev = card()
    rng = np.random.default_rng(R)
    tgt = rng.normal(size=(T, v_chunk)).astype(np.float32)
    valid = rng.random((T, R)) < 0.8
    lidx = np.where(valid, rng.integers(0, v_chunk, (T, R)), v_chunk)
    lidx[:, ::7] = np.where(valid[:, ::7], 1, v_chunk)   # a hot slot
    vals = (rng.normal(size=(T, R)) * 10.0 ** rng.integers(
        -3, 4, (T, R))).astype(np.float32)
    args = rng_on(dev, tgt, lidx.astype(np.int32), vals, valid)
    want = kernel.scatter_body(*args, "add")
    got = kernel.fold_scatter_add(*args)
    torch.cuda.synchronize()
    assert kernel.fold_scatter_add.path == kernel.add_chunks(R)
    assert_same([got], [want], f"R={R}")


@pytest.mark.cuda
@pytest.mark.parametrize("nb,b,cap", [(2, 2050, 40000), (64, 65536, 16385),
                                      (3, 20000, 20000)])
def test_scatter_segments_add_kernel_in_chunks(nb, b, cap):
    dev = card()
    rng = np.random.default_rng(cap)
    base = rng.normal(size=(nb, b)).astype(np.float32)
    idx = rng.integers(-1, b, (nb, cap))
    idx[:, ::5] = 3
    vals = rng.normal(size=(nb, cap)).astype(np.float32)
    args = rng_on(dev, base, idx.astype(np.int32), vals)
    want = binned_scatter(*args, "add")
    got = scatter_segments(*args, op="add")
    torch.cuda.synchronize()
    assert scatter_segments.path == kernel.add_chunks(cap)
    assert_same([got], [want], f"cap={cap}")


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8193, 16448, 60000])
def test_queue_push_pop_kernel_past_8192_fresh_rows(m):
    """The unfused turn with m fresh rows (the last past STAGE_SMEM_MAX:
    the device scratch), full, empty and overflowing queues among the
    tiles, bitwise its plain version by ``turn_contract`` (the turned
    queue below its count)."""
    dev = card()
    rng = np.random.default_rng(m)
    T, cap, w, max_n = 4, 70000, 4, 64
    data = rng.integers(-9, 1 << 22, (T, cap, w)).astype(np.int32)
    count = np.array([0, cap, cap - 2, 100], np.int32)
    rows = rng.integers(0, 1 << 22, (T, m, w)).astype(np.int32)
    valid = rng.random((T, m)) < 0.7
    n = np.array([max_n, 0, 5, max_n], np.int32)
    args = rng_on(dev, data, count, rows, valid, n)
    want = kernel.fifo_turn(*args, max_n)
    got = kernel.queue_push_pop(*args, max_n)
    torch.cuda.synchronize()
    assert kernel.queue_push_pop.path == ("device scratch" if m == 60000
                                          else "shared memory")
    assert_same(kernel.turn_contract(got), kernel.turn_contract(want),
                f"m={m}")


@pytest.mark.cuda
@pytest.mark.parametrize("w", [2, 3, 4, 5])
@pytest.mark.parametrize("cap,m", [(8, 8), (300, 40), (20000, 513)])
def test_queue_push_pop_kernel_turns_live_rows(w, cap, m):
    """The live-row turn over a grid (T, G + 1) (G > 1 at the larger
    capacities), rows of 2, 3, 4 and 5 words: empty, full and overflowing
    tiles, pops below, at and past the old count (fresh rows taken
    directly), bitwise its plain version by ``turn_contract``."""
    dev = card()
    rng = np.random.default_rng(cap * w + m)
    T, max_n = 8, min(cap, 64)
    data = rng.integers(-9, 1 << 22, (T, cap, w)).astype(np.int32)
    count = np.array([0, cap, cap - 2, cap // 2, 3, 0, cap // 3, 1],
                     np.int32)
    rows = rng.integers(0, 1 << 22, (T, m, w)).astype(np.int32)
    valid = rng.random((T, m)) < 0.6
    valid[5] = False                                  # nothing offered
    n = np.array([max_n, 0, 5, max_n, max_n, 1, 0, max_n], np.int32)
    args = rng_on(dev, data, count, rows, valid, n)
    want = kernel.fifo_turn(*args, max_n)
    assert bool((args[4] > args[1]).any())            # n_pop > c0
    got = kernel.queue_push_pop(*args, max_n)
    torch.cuda.synchronize()
    G = kernel.device_split(T, cap, dev).G
    assert (G > 1) == (cap == 20000)
    assert_same(kernel.turn_contract(got), kernel.turn_contract(want),
                f"w={w} cap={cap} m={m} G={G}")


@pytest.mark.cuda
@pytest.mark.parametrize("window", [4096, 65536, 2049])
def test_edge_scan_stream_kernel_any_window(window):
    """T2 over a streamed shard at windows past what fused leg 1 stages
    (STREAM_MAX_WINDOW), the first one past it included: bitwise
    segment_stream under scan_contract; shards shorter than two windows
    included."""
    dev = card()
    for T, e_chunk, R, mt in ((2, 9000, 40, 8), (3, 300, 64, 32),
                              (2, 70000, 100, 32)):
        rng = np.random.default_rng(e_chunk)
        ed = rng.integers(-1, 1 << 22, (T, e_chunk)).astype(np.int32)
        ev = rng.uniform(1, 10, (T, e_chunk)).astype(np.float32)
        start = rng.integers(0, T * e_chunk, (T, R)).astype(np.int32)
        stop = start + rng.integers(0, mt + 1, (T, R)).astype(np.int32)
        rv = rng.random((T, R)) < 0.6
        args = rng_on(dev, ed, ev, start, stop, rv)
        got = kernel.edge_scan_stream(*args, mt, window)
        torch.cuda.synchronize()
        want = kernel.segment_stream(*args, mt, window)
        assert_same(list(kernel.scan_contract(got)),
                    list(kernel.scan_contract(want)),
                    f"window {window} e_chunk {e_chunk}")


# --------------------------------------------------------------------------
# On the card: engine runs past the staging, every fused leg checked
# --------------------------------------------------------------------------

class LegCheck:
    """Within the block, every fused-leg call also runs the leg's plain
    stage on the same operands and is held against it by the legs'
    contract; an IN_PLACE leg must return the queue it was given, and a
    second call must give the same defined bits.  Records (leg, path) of
    every call, and the operands of each leg's first call."""

    def __init__(self, monkeypatch):
        self.mp, self.paths, self.first, self.calls = monkeypatch, set(), {}, 0

    def __enter__(self):
        for k in fused.KERNELS:
            self.mp.setattr(fused, k.__name__, self._wrap(k.__name__, k))
        return self

    def __exit__(self, *exc):
        for k in fused.KERNELS:
            self.mp.setattr(fused, k.__name__, k)

    def _wrap(self, name, real):
        def call(tmpl, plain, *ops):
            got = real(tmpl, plain, *ops)
            self.paths.add((name, real.path))
            self.first.setdefault(name, (real, tmpl, plain, ops))
            check_call(name, real, tmpl, plain, ops, got)
            self.calls += 1
            return got
        return call


@contextlib.contextmanager
def uncounted():
    """Launches outside the round's Stats.launches tally (a check's second
    call of a leg)."""
    stack = launch_records._stack()
    saved = stack[:]
    stack.clear()
    try:
        yield
    finally:
        stack[:] = saved


def check_call(name, real, tmpl, plain, ops, got):
    st = ops[2]
    if name in fused.IN_PLACE:
        i = fused.IN_PLACE[name]
        assert got[0].queues[i].data.data_ptr() == \
            st.queues[i].data.data_ptr(), name
    defined, past = fused.contract(name, tmpl, st, got)
    assert_same(defined, fused.contract(name, tmpl, st, plain(*ops))[0],
                name)
    assert not bool(past.any()), name
    with uncounted():
        again = real(tmpl, plain, *ops)
    assert_same(fused.contract(name, tmpl, st, again)[0], defined,
                f"{name} again")


def assert_stats_equal(a, b, where):
    for f, x, y in zip(a._fields, a, b):
        if f != "launches":
            assert torch.equal(bits(x), bits(y)), (where, f)


@pytest.fixture(scope="module")
def graphs():
    n, src, dst, val = rmat_edges(10, edge_factor=10, seed=1)
    g = CSRGraph.from_edges(n, src, dst, val)
    n, src, dst, val = rmat_edges(8, edge_factor=5, seed=2)
    gs = alg.symmetrize(CSRGraph.from_edges(n, src, dst, val))
    leaf = CSRGraph.from_edges(8, np.array([0]), np.array([1]),
                               np.ones(1, np.float32))
    return g, gs, leaf


def runner(case, graphs, dev):
    """(run(cfg), knobs, paths wanted) of one case."""
    g, gs, leaf = graphs
    root = int(np.argmax(g.ptr[1:] - g.ptr[:-1]))
    x = np.random.default_rng(3).normal(size=g.num_vertices) \
        .astype(np.float32)
    t257 = dict(cap_route_range=2, max_t2=8)
    pops = dict(f_pop=512, r_pop=512)
    # 65,536 frontier pops: leg 0's staging (1.4 MB a tile) and the
    # unfused range-queue turn's 65,536 fresh rows, past STAGE_SMEM_MAX
    scratch = dict(f_pop=65536, cap_rangeq=262144)
    # the triangles' leg 0 and wedge leg at 16,384 popped rows
    tri_scratch = dict(r_pop=16384, cap_rangeq=65536)

    def bfs(graph, T, r=None):
        pg = alg.prepare(graph, T, device=dev)
        return lambda c: alg.bfs(pg, root if r is None else r, c)

    def spmv(T):
        pg = alg.prepare(g, T, device=dev)
        return lambda c: alg.spmv(pg, x, c)

    def kcore(T):
        pg = alg.prepare(gs if T < 100 else alg.symmetrize(g), T, device=dev)
        return lambda c: alg.kcore(pg, 5, c)

    def triangles(T):
        pg = alg.prepare_triangles(gs, T, device=dev)
        return lambda c: alg.triangles(pg, c)

    return {
        "spmv-T257": (spmv(257), t257, {("fused_leg2", "2 chunks")}),
        "kcore5-T257": (kcore(257), t257, {("fused_kcore_leg2", "2 chunks")}),
        "bfs-pops512": (bfs(g, 16), pops, {("fused_leg0", "shared memory")}),
        "bfs-empty-pops512": (bfs(leaf, 4, 7), pops,
                              {("fused_leg0", "shared memory")}),
        "triangles-pops512": (triangles(4), pops,
                              {("fused_tri_leg0", "shared memory"),
                               ("fused_tri_leg2", "shared memory")}),
        "triangles-wedges": (triangles(16), dict(cap_route_update=1040),
                             {("fused_tri_leg4", fused.CLOSE_PATH)}),
        "bfs-window4096": (bfs(g, 16), dict(edge_space="hbm",
                                            hbm_window=4096),
                           {("fused_leg1", "device window")}),
        "kcore5-window4096": (kcore(4), dict(edge_space="hbm",
                                             hbm_window=4096),
                              {("fused_leg1", "device window")}),
        "bfs-scratch": (bfs(g, 16), scratch,
                        {("fused_leg0", "device scratch")}),
        "triangles-scratch": (triangles(4), tri_scratch,
                              {("fused_tri_leg0", "device scratch"),
                               ("fused_tri_leg2", "device scratch")}),
        "spmv-chunks": (spmv(257), dict(t257, cap_route_update=128),
                        {("fused_leg2", "3 chunks")}),
        "kcore5-chunks": (kcore(257), dict(t257, cap_route_update=128),
                          {("fused_kcore_leg2", "3 chunks")}),
        "triangles-chunks": (triangles(16), dict(cap_route_update=2100),
                             {("fused_tri_leg4", fused.CLOSE_PATH)}),
        "bfs-device-window": (bfs(g, 4), dict(edge_space="hbm",
                                              hbm_window=2049),
                              {("fused_leg1", "device window")}),
    }[case]


CASES = ["spmv-T257", "kcore5-T257", "bfs-pops512", "bfs-empty-pops512",
         "triangles-pops512", "triangles-wedges", "bfs-window4096",
         "kcore5-window4096", "bfs-scratch", "triangles-scratch",
         "spmv-chunks", "kcore5-chunks", "triangles-chunks",
         "bfs-device-window"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_fused_runs_past_the_staging_bitwise(monkeypatch, graphs, case):
    """Each configuration the card refused before, fused and unfused:
    values and every Stats field but launches bitwise equal to the "torch"
    backend's, no drops, the launches a round pinned, every fused-leg call
    held against its plain stage (a second call too), and the path wanted
    taken.  Then, on the
    operands of the first call of the scan and wedge legs, their spill
    queue cut to capacity 0."""
    dev = card()
    run, knobs, wanted = runner(case, graphs, dev)
    tri = case.startswith("triangles")
    cfg = EngineConfig(**knobs)
    want = run(dataclasses.replace(cfg, backend="torch"))
    with LegCheck(monkeypatch) as chk:
        got = run(cfg)
    unfused = run(dataclasses.replace(cfg, fuse=False))
    torch.cuda.synchronize()
    for res, per_round in ((got, 5 if tri else 3),
                           (unfused, 8 if tri else 5)):
        np.testing.assert_array_equal(res.values, want.values)
        assert_stats_equal(res.stats, want.stats, case)
        assert int(res.stats.drops) == 0
        assert int(res.stats.launches) == per_round * int(
            res.stats.rounds)
    assert chk.calls == (5 if tri else 3) * int(got.stats.rounds)
    assert wanted <= chk.paths, (wanted, chk.paths)
    for name in ("fused_leg1", "fused_tri_leg2"):
        if name not in chk.first:
            continue
        real, tmpl, plain, ops = chk.first[name]
        st = ops[2]
        i = fused.LIVE_TURN[name]
        q = st.queues[i]
        empty = Queue(q.data[:, :0].contiguous(),
                      torch.zeros_like(q.count))
        queues = st.queues[:i] + (empty,) + st.queues[i + 1:]
        ops = (*ops[:2], st._replace(queues=queues), *ops[3:])
        check_call(name, real, tmpl, plain, ops,
                   real(tmpl, plain, *ops))
