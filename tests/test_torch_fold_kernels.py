"""The T3 fold kernels over column-owning blocks: ``scatter_segments``
(``repro_torch.kernels.scatter_update``), the unfused add fold
``fold_scatter_add`` (``repro_torch.kernels.engine.kernel``) and the fused
leg 2 of the classic and k-core rounds (``repro_torch.kernels.engine.
fused``).

This file imports no JAX, so the card's machine runs it:
``python -m pytest -q -m cuda tests/test_torch_fold_kernels.py``.  The
``cuda`` tests skip without a card.  Anywhere: the column split
(``column_split``), the add fold's launch arguments and the leg-2
wrappers' in-place contract and launch arguments, with the launch
recorded instead of made.  Every comparison is bitwise: the kernels add
each slot's rows in row order, as the plain versions do, and the min is
exact in any order.  ``add_fold_case`` makes the add fold's edge cases,
which ``tests/test_torch_kernels.py`` also runs through the JAX
package's ``fold_scatter``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import algorithms as alg
from repro_torch.core.engine import EngineConfig
from repro_torch.core.graph import CSRGraph, rmat_edges
from repro_torch.core.queues import Queue
from repro_torch.kernels.engine import fused
from repro_torch.kernels.engine import kernel as K
from repro_torch.kernels.engine.kernel import (SPLIT_BLOCKS_PER_SM,
                                               SPLIT_MIN_COLS, SPLIT_QUANTUM,
                                               column_split, device_split)
from repro_torch.kernels.scatter_update import (binned_scatter,
                                                scatter_segments)

pytestmark = pytest.mark.torch_port

H100_SMS = 132
# (NB, b): the TPU tests' shapes (tests/test_kernels.py), the twin's, the
# k-core and main paths' slices (64 tiles of 16,384 and 65,536), b not a
# multiple of 4, b below 4 G, a single slot, none, and one bin of many
SPLIT_CASES = [(4, 128), (2, 64), (3, 32), (2, 16), (16, 64), (64, 16384),
               (64, 65536), (2, 2050), (2, 4101), (7, 513), (1, 3), (64, 1),
               (1, 0), (1, 65537), (132, 100000), (3, 1000003)]


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def assert_same(got, want, where):
    """Every tensor of two (nested) results bitwise equal."""
    if isinstance(want, torch.Tensor):
        assert got.shape == want.shape and got.dtype == want.dtype, where
        assert torch.equal(bits(got), bits(want)), where
        return
    assert len(got) == len(want), where
    for i, (a, b) in enumerate(zip(got, want)):
        if isinstance(b, (torch.Tensor, tuple, list)):
            assert_same(a, b, f"{where}[{i}]")


# --------------------------------------------------------------------------
# The column split
# --------------------------------------------------------------------------

@pytest.mark.parametrize("NB,b", SPLIT_CASES)
def test_column_split_tiles_the_slots(NB, b):
    """The ranges cover [0, b) once each, in order, none empty; every inner
    boundary is a multiple of 4 slots (a 16-byte vector); G >= 1."""
    split = column_split(NB, b, H100_SMS)
    bounds = split.bounds(b)
    assert split.G >= 1 and len(bounds) == split.G + 1
    assert bounds[0] == 0 and bounds[-1] == b
    owned = np.concatenate([np.arange(lo, hi)
                            for lo, hi in zip(bounds, bounds[1:])])
    np.testing.assert_array_equal(owned, np.arange(b))
    assert b == 0 or all(lo < hi for lo, hi in zip(bounds, bounds[1:]))
    assert all(c % SPLIT_QUANTUM == 0 for c in bounds[1:-1])
    assert split.G == 1 or split.step % SPLIT_QUANTUM == 0
    # the launch's view: block j owns [j * step, min((j + 1) * step, b))
    assert bounds == [min(j * split.step, b) for j in range(split.G)] + [b]


@pytest.mark.parametrize("NB,b,G", [
    (64, 65536, 5),     # the main path's leg 2 and the T3 scatter: 320
    (64, 16384, 5),     # the k-core path's leg 2
    (16, 64, 1),        # the twin's slices: narrower than a range
    (4, 128, 1), (2, 2050, 5), (4, 2048, 4),
    (1, 10 ** 6, 264),  # one bin alone fills the card
    (500, 65536, 1)])   # enough bins already
def test_column_split_fills_the_card(NB, b, G):
    """G gives every SM SPLIT_BLOCKS_PER_SM blocks where the bins are too
    few, with at most one range per SPLIT_MIN_COLS slots."""
    split = column_split(NB, b, H100_SMS)
    assert split.G == G
    want = -(-SPLIT_BLOCKS_PER_SM * H100_SMS // NB)
    assert split.G <= max(1, want)
    assert split.G <= max(1, -(-b // SPLIT_MIN_COLS))


# --------------------------------------------------------------------------
# The unfused add fold: its edge cases and its launch
# --------------------------------------------------------------------------

# (T, v_chunk, R) of each edge case of fold_scatter_add.  The plain
# version adds one occurrence rank a pass, so the cases keep the hits a
# slot low (a few hundred passes at most) for the CPU's time.
ADD_FOLD_CASES = {
    "boundaries": (2, 2050, 1024),       # G = 5, beside every boundary
    "boundaries, 2 chunks": (2, 65536, 16385),   # G = 128
    "odd v_chunk": (3, 301, 2000),       # G = 1, v_chunk % 4 == 1
    "-0.0 hit by invalid rows": (2, 2050, 3000),
    "one slot": (2, 2050, 300),          # every row on one slot
    "R 16385": (2, 4096, 16385),         # two chunks of rows
    "R 40000": (2, 2050, 40000),         # three chunks
}


def add_fold_case(kind: str, sms: int = H100_SMS):
    """numpy operands (target, lidx, vals, valid) of one add-fold edge case
    over ``sms`` SMs' column split.  Half the invalid rows lie on the trash
    slot v_chunk, half on a real slot, which they turn from -0.0 to +0.0
    (each adds 0.0, as the reference's masked scatter does); in "-0.0
    hit by invalid rows" only invalid rows reach the -0.0 slots (some in
    every column range)."""
    T, v, R = ADD_FOLD_CASES[kind]
    rng = np.random.default_rng(list(ADD_FOLD_CASES).index(kind))
    tgt = (rng.normal(size=(T, v))
           * 10.0 ** rng.integers(-2, 3, (T, v))).astype(np.float32)
    valid = rng.random((T, R)) < 0.8
    lidx = rng.integers(0, v, (T, R))
    if kind.startswith("boundaries"):
        bounds = np.array(column_split(T, v, sms).bounds(v))
        edges = np.unique(np.clip(bounds[:, None] + [-2, -1, 0, 1], 0,
                                  v - 1))
        lidx = rng.choice(edges, (T, R))
    elif kind == "one slot":
        lidx[:] = 7
    elif kind == "-0.0 hit by invalid rows":
        zeros = np.arange(0, v, 41)
        tgt[:, zeros] = -0.0
        lidx = np.where(valid,
                        rng.choice(np.setdiff1d(np.arange(v), zeros), (T, R)),
                        rng.choice(zeros, (T, R)))
    if kind != "-0.0 hit by invalid rows":
        lidx = np.where(valid | (rng.random((T, R)) < 0.5), lidx, v)
    vals = (rng.normal(size=(T, R))
            * 10.0 ** rng.integers(-3, 4, (T, R))).astype(np.float32)
    return tgt, lidx.astype(np.int32), vals, valid


@pytest.mark.parametrize("T,v_chunk,R,G", [
    (64, 65536, 4096, 5),   # the timed shape
    (2, 2050, 16385, 5), (3, 301, 2000, 1), (257, 4, 16448, 1),
    (1, 65537, 40000, 129)])
def test_add_fold_launches_over_the_column_split(monkeypatch, T, v_chunk, R,
                                                 G):
    """The add fold's CUDA branch (the launch recorded): its grid is the
    column split of the tiles' slices, G and step after the sizes, and the
    wrapper notes the split and the path."""
    calls = []
    monkeypatch.setattr(K, "_check", lambda *operands: None)
    monkeypatch.setattr(K, "_launch", lambda fn, *args: calls.append(
        (fn, args)))
    monkeypatch.setattr(K, "device_split",
                        lambda nb, b, dev: column_split(nb, b, H100_SMS))
    monkeypatch.setattr(K.fold_scatter_add, "launches",
                        K.fold_scatter_add.launches)
    for attr in ("path", "split"):
        monkeypatch.setattr(K.fold_scatter_add, attr,
                            getattr(K.fold_scatter_add, attr))

    def meta(n, dtype):
        return torch.empty((T, n), dtype=dtype, device="meta")

    K.fold_scatter_add(meta(v_chunk, torch.float32), meta(R, torch.int32),
                       meta(R, torch.float32), meta(R, torch.bool))
    (fn, args), = calls
    assert fn == "repro_fold_scatter_add"
    types = K.LIBRARY.signatures[fn][:-1]  # the stream comes last
    assert len(args) == len(types)
    split = column_split(T, v_chunk, H100_SMS)
    assert [a for a in args if isinstance(a, int)] == [T, v_chunk, R,
                                                       split.G, split.step]
    assert K.fold_scatter_add.split == split
    assert K.fold_scatter_add.path == K.add_chunks(R)
    assert split.G == G


# --------------------------------------------------------------------------
# The leg-2 wrappers: operands captured from fused runs
# --------------------------------------------------------------------------

# the tight knobs of the engine tests (the update channel spills), with a
# range queue of 1,024, which BFS in BSP mode at R-MAT-13 needs to drop
# nothing
TIGHT = dict(f_pop=8, r_pop=8, u_pop=16, max_t2=8, cap_route_range=2,
             cap_route_update=4, cap_rangeq=1024, cap_updq=4096,
             max_rounds=20000)
LEG2 = {"bfs": "fused_leg2", "bfs_bsp": "fused_leg2", "spmv": "fused_leg2",
        "kcore": "fused_kcore_leg2"}


def fused_run(app, scale, T, dev):
    n, src, dst, val = rmat_edges(scale, edge_factor=5, seed=scale + T)
    g = CSRGraph.from_edges(n, src, dst, val)
    if app == "kcore":
        g = alg.symmetrize(g)
    pg = alg.prepare(g, T, device=dev)
    root = int(np.argmax(g.ptr[1:] - g.ptr[:-1]))
    cfg = EngineConfig(fuse=True, mode="bsp" if app == "bfs_bsp" else "async",
                       **TIGHT)
    if app == "spmv":
        x = np.random.default_rng(1).normal(size=n).astype(np.float32)
        return lambda: alg.spmv(pg, x, cfg)
    if app == "kcore":
        return lambda: alg.kcore(pg, 3, cfg)
    return lambda: alg.bfs(pg, root, cfg)


def capture(monkeypatch, name, run, hook):
    """Run ``run`` with the fused wrapper ``name`` replaced by ``hook(real,
    tmpl, plain, *ops)``; the engine looks the wrapper up per run."""
    real = getattr(fused, name)
    monkeypatch.setattr(fused, name,
                        lambda tmpl, plain, *ops: hook(real, tmpl, plain,
                                                       *ops))
    res = run()
    monkeypatch.setattr(fused, name, real)
    return res


@pytest.mark.parametrize("app", sorted(LEG2))
def test_leg2_wrapper_appends_in_place(monkeypatch, app):
    """On the CUDA path (here with the launch recorded): the queue operand
    is the state's own update queue ``data``, the returned state's queue
    holds that very tensor, and the folded slice and flags (and k-core's
    ``acc``) are fresh; every launch argument has its C type, and G and
    step are the column split of the tiles' slices."""
    name = LEG2[app]
    calls = []

    def record(real, tmpl, plain, *ops):
        if bool(ops[6].any()) and not calls:  # a call with spills
            calls.append((tmpl, plain, ops))
        return real(tmpl, plain, *ops)

    capture(monkeypatch, name, fused_run(app, 8, 4, "cpu"), record)
    assert calls, "no leg-2 call spilled"
    tmpl, plain, ops = calls[0]
    st = ops[2]
    launches = []
    wrapper = getattr(fused, name)
    monkeypatch.setattr(wrapper, "launches", wrapper.launches)
    monkeypatch.setattr(fused, "_on_cpu", lambda st: False)
    monkeypatch.setattr(fused, "_check", lambda *operands: None)
    monkeypatch.setattr(fused, "_launch",
                        lambda fn, *args: launches.append((fn, args)))
    monkeypatch.setattr(fused, "device_split",
                        lambda nb, b, dev: column_split(nb, b, H100_SMS))
    before = wrapper.launches
    out = wrapper(tmpl, plain, *ops)
    assert wrapper.launches == before + 1
    (fn, args), = launches
    types = fused.LIBRARY.signatures[fn][:-1]  # the stream comes last
    assert len(args) == len(types), fn
    for a, ty in zip(args, types):
        assert isinstance(a, torch.Tensor if ty is fused._P else int), (fn,
                                                                       a)
    uq = st.queues[1]
    assert args[0] is uq.data
    new = out[0]
    assert new.queues[1].data is uq.data
    assert new.queues[0] is st.queues[0]
    T, v_chunk = st.value.shape
    split = column_split(T, v_chunk, H100_SMS)
    ints = [a for a in args if not isinstance(a, torch.Tensor)]
    assert ints[5:7] == [split.G, split.step]
    inputs = [x for x in (st.value, st.acc, st.frontier, st.next_frontier,
                          uq.data, uq.count, *ops[3:7])]
    flags = "frontier" if tmpl.mode == "async" else "next_frontier"
    fresh = {"kcore": ("value", "acc", flags),
             "spmv": ("acc",)}.get(app, ("value", flags))
    for f in fresh:
        x = getattr(new, f)
        assert not any(x is y or x.data_ptr() == y.data_ptr()
                       for y in inputs), f
    for f in set(("value", "acc", "frontier", "next_frontier")) - set(fresh):
        assert getattr(new, f) is getattr(st, f), f


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

def seg_case(kind, op, seed):
    """Operands of one edge case of the card's split (G > 1 in each but
    "wide")."""
    dev = card()
    rng = np.random.default_rng(seed)
    nb, b, cap = {"boundaries": (2, 2050, 4096), "range-ends": (3, 4101, 2048),
                  "b % 4 == 1": (2, 4101, 4096), "empty bins": (4, 2050, 64),
                  "cap 1": (5, 2050, 1), "one range": (2, 4101, 4096),
                  "T3": (64, 65536, 4096), "wide": (300, 20000, 256)}[kind]
    split = device_split(nb, b, dev)
    assert split.G > 1 or kind == "wide", split
    bounds = np.array(split.bounds(b))
    idx = rng.integers(-1, b, (nb, cap))
    if kind == "boundaries":  # duplicates on both sides of each boundary
        edges = np.unique(np.clip(bounds[:, None] + [-2, -1, 0, 1], 0, b - 1))
        idx = rng.choice(edges, (nb, cap))
    elif kind == "range-ends":  # the first and last slot of every range
        ends = np.unique(np.concatenate([bounds[:-1], bounds[1:] - 1]))
        idx = rng.choice(ends, (nb, cap))
    elif kind == "empty bins":
        idx[1:3] = -1
    elif kind == "one range":  # every row in the third range
        idx = rng.integers(bounds[2], bounds[3], (nb, cap))
    idx = np.where(rng.random((nb, cap)) < 0.1, -1, idx)
    base = rng.normal(size=(nb, b)).astype(np.float32)
    vals = rng.normal(size=(nb, cap)).astype(np.float32)
    if op == "min":  # some updates below the base, some above
        vals *= 3
    return [torch.from_numpy(a).to(dev)
            for a in (base, idx.astype(np.int32), vals)]


# "wide": one range a bin of more than SINGLE_MAX_SLOTS slots (the add
# sorts every row in range)
SEG_KINDS = ["boundaries", "range-ends", "b % 4 == 1", "empty bins", "cap 1",
             "one range", "T3", "wide"]


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["add", "min"])
@pytest.mark.parametrize("kind", SEG_KINDS)
def test_scatter_segments_kernel_bitwise_at_split_edges(kind, op):
    args = seg_case(kind, op, seed=SEG_KINDS.index(kind))
    before = scatter_segments.launches
    got = scatter_segments(*args, op=op)
    torch.cuda.synchronize()
    assert scatter_segments.launches == before + 1
    assert_same(got, binned_scatter(*args, op), f"{kind} {op}")
    assert_same(scatter_segments(*args, op=op), got, f"{kind} {op} again")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(ADD_FOLD_CASES))
def test_fold_scatter_add_kernel_bitwise_at_split_edges(kind):
    """The add fold over the card's column split, bitwise its plain
    version (``scatter_body(..., "add")``), twice."""
    dev = card()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    args = [torch.from_numpy(a).to(dev) for a in add_fold_case(kind, sms)]
    T, v_chunk = args[0].shape
    before = K.fold_scatter_add.launches
    got = K.fold_scatter_add(*args)
    torch.cuda.synchronize()
    assert K.fold_scatter_add.launches == before + 1
    split = device_split(T, v_chunk, dev)
    assert K.fold_scatter_add.split == split
    assert split.G > 1 or kind == "odd v_chunk", split
    assert_same(got, K.scatter_body(*args, "add"), kind)
    assert_same(K.fold_scatter_add(*args), got, f"{kind} again")


@pytest.mark.cuda
@pytest.mark.parametrize("app", sorted(LEG2))
def test_fused_leg2_kernel_bitwise_in_place(monkeypatch, app):
    """Every leg-2 call of a fused run at R-MAT-13 over 4 tiles (slices of
    2,048 slots: G = 4) against its plain stage, bitwise, spills and all;
    it returns the queue it was given, a second call on the same operands
    gives the same bits, and so does a cap-0 update queue."""
    dev = card()
    name = LEG2[app]
    seen = {"calls": 0, "spills": 0}
    cap0 = []

    def check(real, tmpl, plain, *ops):
        uq = ops[2].queues[1]
        got = real(tmpl, plain, *ops)
        assert got[0].queues[1].data.data_ptr() == uq.data.data_ptr()
        assert_same(got, plain(*ops), f"{name} call {seen['calls']}")
        assert_same(real(tmpl, plain, *ops), got, f"{name} second call")
        seen["calls"] += 1
        if bool(ops[6].any()):
            seen["spills"] += 1
            if not cap0:
                cap0.append((real, tmpl, plain, ops))
        return got

    res = capture(monkeypatch, name, fused_run(app, 13, 4, dev), check)
    torch.cuda.synchronize()
    assert seen["calls"] == int(res.stats.rounds) > 1
    assert seen["spills"] > 0 and int(res.stats.drops) == 0
    real, tmpl, plain, ops = cap0[0]
    st = ops[2]
    rq, uq = st.queues
    empty = Queue(uq.data[:, :0].contiguous(), torch.zeros_like(uq.count))
    ops = (*ops[:2], st._replace(queues=(rq, empty)), *ops[3:])
    assert_same(real(tmpl, plain, *ops), plain(*ops), f"{name} cap-0 queue")
    T, v_chunk = st.value.shape
    assert device_split(T, v_chunk, dev).G > 1
