"""The serving lanes' comm and the lane axis of the four kernels that
read the shard (fused legs 0 and 1, ``edge_scan_gather``,
``edge_scan_stream``), port only: this file imports no JAX, so the card's
machine runs it: ``python -m pytest -q -m cuda
tests/test_torch_lane_kernels.py``.

Anywhere: ``LaneComm``'s collectives are ``LocalComm``'s lane by lane; a
cleared queue is a fresh one; the wrappers launch once for B * T state
rows over a (T, ...) shard, the shard's T passed beside the rows
(launches recorded on meta tensors), and refuse rows that are no multiple
of the tiles; the scans' plain versions read shard row ``row % T``.  On
the card (``cuda``): both scans' kernels against their plain versions at
B = 3, and a B = 3 batch fused (every fused-leg call held against its
plain stage by the legs' contract) and unfused, against the "torch" path
and each lane against its solo run.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import algorithms as ta
from repro_torch.core import reference as tref
from repro_torch.core.comm import LaneComm, LocalComm
from repro_torch.core.engine import EngineConfig as TConfig
from repro_torch.core.graph import CSRGraph, rmat_edges
from repro_torch.core.queues import queue_clear, queue_make
from repro_torch.kernels.engine import fused
from repro_torch.kernels.engine import kernel as K
from repro_torch.serve import multi_source
from test_torch_staging import (CLASSIC, LegCheck, card, launched,
                                launches, messages, shard, state,
                                template)
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

# tests/test_serve.py's small_cfg knobs
SMALL = dict(f_pop=8, r_pop=8, u_pop=16, max_t2=8, cap_route_range=8,
             cap_route_update=32, cap_rangeq=256, cap_updq=4096,
             max_rounds=20000)


def test_queue_clear_is_a_fresh_queue():
    q = queue_make(4, 16, 3, device="cpu")
    q = q._replace(data=torch.arange(q.data.numel(), dtype=torch.int32)
                   .view(q.data.shape), count=torch.full((4,), 5,
                                                         dtype=torch.int32))
    c, fresh = queue_clear(q), queue_make(4, 16, 3, device="cpu")
    assert torch.equal(c.data, fresh.data) and torch.equal(c.count,
                                                           fresh.count)
    assert c.data.dtype == fresh.data.dtype and c.data.shape == (4, 16, 3)


def test_lane_comm_is_local_comm_a_lane():
    """Every collective of a B-lane comm is LocalComm's on each lane's T
    rows; ``me`` is the tile within its lane."""
    B, T = 3, 4
    lc, one = LaneComm(T, B), LocalComm(T)
    x = torch.arange(B * T * T * 2, dtype=torch.int32).view(B * T, T * 2)
    for name in ("a2a", "psum", "pmax", "all_gather"):
        got = getattr(lc, name)(x)
        for b in range(B):
            want = getattr(one, name)(x[b * T:(b + 1) * T])
            assert torch.equal(got[b * T:(b + 1) * T], want), name
    assert torch.equal(lc.to_global(lc.psum(x)),
                       torch.stack([one.to_global(one.psum(
                           x[b * T:(b + 1) * T])) for b in range(B)]))
    assert lc.my_id().tolist() == list(range(T)) * B
    assert (lc.rows, one.rows) == (B * T, T)


# --------------------------------------------------------------------------
# The lane axis of the four kernels that read the shard.
# --------------------------------------------------------------------------

B3, T3 = 3, 64


def test_shard_legs_launch_once_for_every_lane(launches):  # noqa: F811
    """Fused legs 0 and 1 on B * T state rows over a (T, ...) shard: one
    launch, its grid over the B * T rows, the shard's T after them; rows
    that are no multiple of the tiles are refused."""
    sh = shard(T3, 4096, 9000)
    st = state(B3 * T3, 4096, CLASSIC)
    out = fused.fused_leg0(template(), None, None, sh, st)
    fn, args = launched(launches, fused.LIBRARY)
    ints = [a for a in args if isinstance(a, int)]
    assert fn == "repro_fused_leg0" and ints[:2] == [B3 * T3, T3]
    assert out[1].shape == (B3 * T3, 32, 3)
    out = fused.fused_leg1(template(), None, None, sh, st,
                           *messages(B3 * T3, 128, 3),
                           *messages(B3 * T3, 40, 3),
                           torch.empty((B3 * T3, 2), dtype=torch.int32,
                                       device="meta"))
    fn, args = launched(launches, fused.LIBRARY)
    ints = [a for a in args if isinstance(a, int)]
    assert fn == "repro_fused_leg1" and ints[:2] == [B3 * T3, T3]
    assert out[1].shape == (B3 * T3, 64 + 128 * 32, 2)
    with pytest.raises(ValueError, match="multiple of the tiles"):
        fused.fused_leg0(template(), None, None, sh,
                         state(B3 * T3 + 1, 4096, CLASSIC))


def test_scans_take_lane_rows_over_one_shard(monkeypatch):
    """The scans' plain versions on B * T rows read shard row ``row % T``:
    equal, lane by lane, to a scan of each lane over the shard; the
    wrappers launch once with the rows and the shard's tiles."""
    rng = np.random.default_rng(3)
    T, e_chunk, R, mt = 4, 60, 9, 7
    dst = torch.from_numpy(rng.integers(-1, 500, (T, e_chunk),
                                        dtype=np.int32))
    val = torch.from_numpy(rng.random((T, e_chunk), dtype=np.float32))
    start = torch.from_numpy(rng.integers(0, 4 * e_chunk, (B3 * T, R),
                                          dtype=np.int32))
    stop = start + torch.from_numpy(rng.integers(0, 12, (B3 * T, R),
                                                 dtype=np.int32))
    rv = torch.from_numpy(rng.random((B3 * T, R)) < 0.7)
    for scan, extra in ((K.segment_gather, ()), (K.segment_stream, (16,))):
        got = scan(dst, val, start, stop, rv, mt, *extra)
        for b in range(B3):
            rows = slice(b * T, (b + 1) * T)
            want = scan(dst, val, start[rows], stop[rows], rv[rows], mt,
                        *extra)
            for x, y in zip(got, want):
                assert torch.equal(x[rows], y)
    calls = []
    monkeypatch.setattr(K, "_check", lambda *operands: None)
    monkeypatch.setattr(K, "_launch", lambda fn, *a: calls.append((fn, a)))
    for w in (K.edge_scan_gather, K.edge_scan_stream):
        monkeypatch.setattr(w, "launches", w.launches)
    meta = [x.to("meta") for x in (dst, val, start, stop, rv)]
    K.edge_scan_gather(*meta, mt)
    K.edge_scan_stream(*meta, mt, 16)
    assert [a[8:10] for _, a in calls] == [(B3 * T, T)] * 2
    with pytest.raises(ValueError, match="multiple of the tiles"):
        K.segment_gather(dst, val, start[:5], stop[:5], rv[:5], mt)


@pytest.mark.cuda
def test_scan_kernels_at_three_lanes():
    """Both scans' kernels on 3 lanes of (64, 39134)-shard operands
    against their plain versions, by ``scan_contract``."""
    dev = card()
    rng = np.random.default_rng(5)
    T, e_chunk, R, mt = 64, 39134, 256, 32
    dst = torch.from_numpy(rng.integers(-1, 1 << 20, (T, e_chunk),
                                        dtype=np.int32)).to(dev)
    val = torch.from_numpy(rng.random((T, e_chunk), dtype=np.float32)) \
        .to(dev)
    start = torch.from_numpy(rng.integers(0, 64 * e_chunk, (B3 * T, R),
                                          dtype=np.int32)).to(dev)
    stop = start + torch.from_numpy(rng.integers(0, 40, (B3 * T, R),
                                                 dtype=np.int32)).to(dev)
    rv = torch.from_numpy(rng.random((B3 * T, R)) < 0.5).to(dev)
    for scan, plain, extra in (
            (K.edge_scan_gather, K.segment_gather, ()),
            (K.edge_scan_stream, K.segment_stream, (128,))):
        got = K.scan_contract(scan(dst, val, start, stop, rv, mt, *extra))
        want = K.scan_contract(plain(dst, val, start, stop, rv, mt, *extra))
        torch.cuda.synchronize()
        for x, y in zip(got, want):
            assert torch.equal(x, y), scan.__name__


@pytest.mark.cuda
@pytest.mark.parametrize("fuse", [True, False])
def test_lane_kernels_on_the_card(monkeypatch, fuse):
    """A B = 3 batch on the card: every fused-leg call held against its
    plain stage by the legs' contract (fused), the lanes' values and
    Stats equal to the "torch" path's and each lane to its solo run."""
    dev = card()
    n, src, dst, val = rmat_edges(7, edge_factor=5, seed=0)
    g = CSRGraph.from_edges(n, src, dst, val)
    tpg = ta.prepare(g, T=8, device=dev)
    deg = g.ptr[1:] - g.ptr[:-1]
    srcs = np.random.default_rng(1).choice(np.flatnonzero(deg > 0), 2)
    batch = [int(srcs[0]), -1, int(srcs[1])]
    cfg = TConfig(fuse=fuse, **SMALL)
    with LegCheck(monkeypatch) as chk:
        res = multi_source(tpg, "bfs", batch, cfg)
    assert (chk.calls > 0) == fuse
    plain = multi_source(tpg, "bfs", batch,
                         dataclasses.replace(cfg, backend="torch"))
    np.testing.assert_array_equal(res.values, plain.values)
    for f, a, b in zip(res.stats._fields, res.stats, plain.stats):
        if f != "launches":
            assert torch.equal(a, b), f
    for lane, s in enumerate(batch):
        if s >= 0:
            solo = ta.bfs(tpg, s, cfg)
            np.testing.assert_array_equal(res.values[lane], solo.values)
            np.testing.assert_array_equal(res.values[lane],
                                          tref.bfs_ref(g, s))
            for f, a, b in zip(solo.stats._fields, res.stats, solo.stats):
                assert torch.equal(a[lane], b), f
