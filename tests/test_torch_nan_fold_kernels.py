"""The min folds on NaN and signed zeros: the plain versions
(``scatter_body``, ``binned_scatter``, both through ``min_fold``) against a
serial oracle of the rule, and on the card every kernel that folds through
``atomic_min_f32`` (``fold_scatter`` staged and past its staging,
``scatter_segments``, the fused leg 2's min fold) against its plain
version, bit for bit.

The rule (``repro_torch.kernels.engine.kernel.fold_order_key``) is the JAX
package's: XLA's ``minimum`` folded serially over a slot's sequence (the
target, then its rows in row order) keeps the first NaN whose sign bit is
clear, else the last NaN whose sign bit is set, else the least number,
-0.0 below +0.0; a NaN keeps its payload.  ``tests/test_torch_min_fold_nan
.py`` holds the same cases against the JAX package.

This file imports no JAX, so the card's machine runs it:
``python -m pytest -q -m cuda tests/test_torch_nan_fold_kernels.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.engine import fused
from repro_torch.kernels.engine import kernel as K
from repro_torch.kernels.scatter_update import (binned_scatter,
                                                scatter_segments)
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port


def N(k):
    """A NaN with a clear sign bit and payload k (quiet)."""
    return 0x7FC00000 + k


def M(k):
    """A NaN with a set sign bit and payload k (quiet)."""
    return 0xFFC00000 + k


ONE, HALF, TWO = 0x3F800000, 0x3F000000, 0x40000000
PZ, NZ, PINF, NINF = 0x00000000, 0x80000000, 0x7F800000, 0xFF800000
SNAN, SNAN_NEG = 0x7F800001, 0xFFBFFFFF   # signalling NaNs
FMAX = 0x7F7FFFFF

# Each case: the sequences of its slots, [target, row, row, ...] in row
# order, as float32 bits.
NAN_CASES = {
    "two positive NaNs, both orders": [[ONE, N(1), N(2)],
                                       [ONE, N(2), N(1)]],
    "two negative NaNs, both orders": [[ONE, M(1), M(2)],
                                       [ONE, M(2), M(1)]],
    "NaNs of both signs, both orders": [[ONE, M(1), N(2)],
                                        [ONE, N(2), M(1)]],
    "a NaN target and a NaN row": [[N(1), N(2)], [N(2), N(1)], [M(1), M(2)],
                                   [M(2), M(1)], [M(1), N(2)], [N(2), M(1)],
                                   [M(5), N(3), N(1)]],
    "NaN against infinities": [[N(1), NINF], [NINF, N(1)], [M(1), NINF],
                               [NINF, M(1)], [ONE, N(1), PINF],
                               [ONE, NINF, M(1)], [ONE, M(1), NINF]],
    "NaN against signed zeros": [[N(1), NZ], [PZ, N(1)], [M(1), PZ],
                                 [NZ, M(1)], [ONE, NZ, N(3), PZ]],
    "three NaNs": [[ONE, N(1), N(2), N(3)], [ONE, N(3), N(2), N(1)],
                   [ONE, M(1), M(2), M(3)], [ONE, M(3), M(2), M(1)],
                   [ONE, M(1), N(2), M(3)], [ONE, N(3), M(2), N(1)],
                   [ONE, M(3), HALF, M(1)]],
    "signalling NaNs": [[ONE, SNAN, N(2)], [ONE, SNAN_NEG, M(2)],
                        [SNAN, HALF], [HALF, SNAN_NEG, NZ]],
    "signed zeros": [[PZ, NZ, PZ], [NZ, PZ], [PZ, PZ, NZ], [NZ, NZ, PZ],
                     [PZ, PZ], [NZ]],
    "numbers": [[FMAX, TWO, ONE, HALF], [TWO, FMAX], [NINF, ONE],
                [PINF, FMAX]],
}


def serial_min(seq):
    """The rule over one sequence of float32 bits."""
    u = np.array(seq, np.uint32)
    nan = (u & 0x7FFFFFFF) > 0x7F800000
    pos = nan & (u < 0x80000000)
    if pos.any():
        return int(u[np.argmax(pos)])
    if nan.any():
        return int(u[np.nonzero(nan)[0][-1]])
    key = np.where(u >= 0x80000000, -(u & 0x7FFFFFFF).astype(np.int64) - 1,
                   u.astype(np.int64))
    return int(u[np.argmin(key)])


def fold_case(seqs, T=1, v_chunk=None, spread=1, seed=0):
    """One min fold holding ``seqs`` in tile 0 (slot ``spread * i`` for
    sequence i), the rows of all sequences interleaved, each sequence's in
    its order, plus invalid rows (on real slots and on the trash slot) that
    carry NaNs and -0.0, which must change nothing.  The other slots and
    tiles hold numbers.  Returns ((target, lidx, vals, valid) as numpy,
    the slots of tile 0 that hold the sequences)."""
    rng = np.random.default_rng(seed)
    n = len(seqs)
    v_chunk = v_chunk or spread * n
    slots = [spread * i for i in range(n)]
    tgt = rng.normal(0, 10, (T, v_chunk)).astype(np.float32).view(np.uint32)
    for s, seq in zip(slots, seqs):
        tgt[0, s] = seq[0]
    order = []  # (sequence, its row) in an interleaved row order
    pending = [list(seq[1:]) for seq in seqs]
    while any(pending):
        for i in rng.permutation(n):
            if pending[i]:
                order.append((i, pending[i].pop(0)))
    junk = [(int(rng.integers(0, v_chunk + 1)), x)
            for x in (N(9), M(9), NZ, SNAN)]
    R = len(order) + len(junk)
    lidx = rng.integers(0, v_chunk, (T, R)).astype(np.int32)
    vals = rng.normal(0, 10, (T, R)).astype(np.float32).view(np.uint32)
    valid = rng.random((T, R)) < 0.9
    rows = [(slots[i], x, True) for i, x in order] + \
        [(s, x, False) for s, x in junk]
    at = np.sort(rng.choice(R, len(order), replace=False))
    rest = [r for r in range(R) if r not in set(at.tolist())]
    for r, (s, x, ok) in zip([*at, *rest], rows):
        lidx[0, r], vals[0, r], valid[0, r] = s, x, ok
    lidx = np.where(valid, lidx, np.where(lidx % 2 == 0, v_chunk, lidx))
    return (tgt.view(np.float32), lidx.astype(np.int32),
            vals.view(np.float32), valid), slots


def as_bins(target, lidx, vals, valid):
    """The same fold as ``scatter_segments`` operands: an invalid row, and
    a row on the trash slot, is an empty slot (-1)."""
    v_chunk = target.shape[1]
    idx = np.where(valid & (lidx < v_chunk), lidx, -1).astype(np.int32)
    return target, idx, vals


def tensors(arrays, dev="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays]


def bits(x):
    x = x.cpu() if isinstance(x, torch.Tensor) else torch.from_numpy(x)
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("case", sorted(NAN_CASES))
def test_plain_min_folds_follow_the_serial_rule(case):
    """``scatter_body`` (engine) and ``binned_scatter`` (block) give, in
    every slot of the case, the rule's bits over its target and rows; the
    other slots their serial min; the invalid rows and empty slots carrying
    NaNs change nothing."""
    seqs = NAN_CASES[case]
    ops, slots = fold_case(seqs, T=2, spread=3)
    out = K.scatter_body(*tensors(ops), "min").view(torch.int32).numpy()
    seg = binned_scatter(*tensors(as_bins(*ops)), "min").view(
        torch.int32).numpy()
    tgt, lidx, vals, valid = ops
    v_chunk = tgt.shape[1]
    for t in range(2):
        for s in range(v_chunk):
            on = lidx[t] == s
            # scatter_body folds an invalid row on a real slot as the
            # neutral float32 max; a bin's empty slot folds nothing
            rows = np.where(valid[t][on], vals[t][on].view(np.uint32), FMAX)
            live = vals[t][on & valid[t]].view(np.uint32)
            start = int(tgt[t, s].view(np.uint32))
            assert out[t, s] == np.int32(np.uint32(
                serial_min([start, *rows]))), (case, t, s)
            assert seg[t, s] == np.int32(np.uint32(
                serial_min([start, *live]))), (case, t, s)
    for s, seq in zip(slots, seqs):
        assert out[0, s] == np.int32(np.uint32(serial_min(seq))), (case, s)


def test_min_fold_parts_cut_rows_past_the_ticket_range(monkeypatch):
    """A standalone min fold of more rows a tile than a ticket can rank
    folds them in parts of MIN_FOLD_MAX_ROWS rows, each launch's output
    the next one's target (the serial fold is the same); the fused leg 2
    refuses such a fold (its kernel folds one part)."""
    monkeypatch.setattr(K, "MIN_FOLD_MAX_ROWS", 4)
    rows = [torch.arange(10).reshape(1, 10) + k for k in range(3)]
    parts = K.min_fold_parts(*rows)
    assert [p[0].shape[1] for p in parts] == [4, 4, 2]
    for p in parts:
        assert all(x.is_contiguous() for x in p)
    assert torch.equal(torch.cat([p[2] for p in parts], 1), rows[2])
    small = [x[:, :4] for x in rows]
    assert K.min_fold_parts(*small)[0][0] is small[0]
    launches = []
    monkeypatch.setattr(K, "_launch", lambda fn, *a: launches.append(a))
    monkeypatch.setattr(K, "_check", lambda *a: None)
    monkeypatch.setattr(K, "device_split",
                        lambda nb, b, dev: K.column_split(nb, b, 132))
    meta = dict(device="meta")
    K.fold_scatter(torch.empty((2, 8), **meta),
                   torch.empty((2, 10), dtype=torch.int32, **meta),
                   torch.empty((2, 10), **meta),
                   torch.empty((2, 10), dtype=torch.bool, **meta))
    assert [a[7] for a in launches] == [4, 4, 2]  # R of each launch
    assert launches[1][0] is launches[0][4]       # chained targets
    monkeypatch.setattr(fused, "MIN_FOLD_MAX_ROWS", 4)
    monkeypatch.setattr(fused, "_on_cpu", lambda st: False)
    tmpl = fused.LegTemplate("value", "plus1", "min", 0, "async", "traffic",
                             0, 8, (8, 16), 8, 0)
    with pytest.raises(ValueError, match="at most 4"):
        fused.fused_leg2(tmpl, None, None, None,
                         _meta_state(), torch.empty((2, 10, 2), **meta),
                         torch.empty((2, 10), **meta),
                         torch.empty((2, 3, 2), **meta),
                         torch.empty((2, 3), **meta))


def _meta_state():
    from repro_torch.core.engine import EngineState
    from repro_torch.core.queues import Queue
    z = torch.empty((2, 8), device="meta")
    q = Queue(torch.empty((2, 16, 2), dtype=torch.int32, device="meta"),
              torch.empty(2, dtype=torch.int32, device="meta"))
    return EngineState(z, z, z.bool(), z.bool(), (q, q),
                       torch.empty(2, dtype=torch.int32, device="meta"))


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


# placements of a case: (T, v_chunk, spread): one slot a sequence in a
# one-block slice; sequences 290 slots apart over the (2, 2050) slices'
# five column ranges of 412 slots (staged in shared memory); and the (64,
# 262,144) slices, whose ranges of 52,432 slots pass the staging (the fold
# beside the copy, global atomics)
PLACEMENTS = {"one block": (1, None, 1), "five ranges": (2, 2050, 290),
              "past the staging": (64, 262144, 7000)}


@pytest.mark.cuda
@pytest.mark.parametrize("where", sorted(PLACEMENTS))
@pytest.mark.parametrize("case", sorted(NAN_CASES))
def test_min_fold_kernels_bitwise_on_nan_and_zeros(case, where):
    """fold_scatter's kernel against scatter_body, and scatter_segments'
    min against binned_scatter, bitwise, on every case at every
    placement."""
    dev = card()
    T, v_chunk, spread = PLACEMENTS[where]
    ops, _ = fold_case(NAN_CASES[case], T, v_chunk, spread)
    args = tensors(ops, dev)
    got = K.fold_scatter(*args)
    torch.cuda.synchronize()
    assert torch.equal(bits(got), bits(K.scatter_body(*args, "min"))), \
        (case, where, K.fold_scatter.path)
    if where == "past the staging":
        assert K.fold_scatter.path == "folded beside the copy"
    seg = tensors(as_bins(*ops), dev)
    got = scatter_segments(*seg, op="min")
    torch.cuda.synchronize()
    assert torch.equal(bits(got), bits(binned_scatter(*seg, "min"))), \
        (case, where)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(NAN_CASES))
def test_fused_leg2_min_fold_bitwise_on_nan_and_zeros(monkeypatch, case):
    """The fused leg 2's min fold (BFS) on a leg-2 call of a fused run
    whose tile 0 holds the case (targets in value, rows in the delivered
    messages, the other rows of tile 0 invalid), against its plain stage:
    every output bitwise, the re-armed flags included."""
    from repro_torch.core import algorithms as alg
    from repro_torch.core.engine import EngineConfig
    from repro_torch.core.graph import CSRGraph, rmat_edges
    from test_torch_fold_kernels import capture
    dev = card()
    kept = []

    def keep(real, tmpl, plain, *ops):
        if not kept:
            kept.append((real, tmpl, plain, ops))
        return real(tmpl, plain, *ops)

    # BFS on R-MAT-10 over 4 tiles, default knobs: 256 rows a leg-2 call
    n, src, dst, val = rmat_edges(10, edge_factor=5, seed=1)
    pg = alg.prepare(CSRGraph.from_edges(n, src, dst, val), 4, device=dev)
    capture(monkeypatch, "fused_leg2",
            lambda: alg.bfs(pg, 0, EngineConfig(fuse=True)), keep)
    real, tmpl, plain, ops = kept[0]
    me, sh, st, recv, rv, sp, spv = ops
    v_chunk = st.value.shape[1]
    seqs = NAN_CASES[case]
    (tgt, lidx, vals, valid), slots = fold_case(seqs, 1, v_chunk,
                                                v_chunk // len(seqs))
    n = lidx.shape[1]
    assert n <= recv.shape[1], (n, recv.shape)
    value = st.value.clone()
    value[0] = torch.from_numpy(tgt[0]).to(dev)
    recv, rv = recv.clone(), rv.clone()
    rv[0] = False
    recv[0, :n, 0] = torch.from_numpy(lidx[0]).to(dev)
    recv[0, :n, 1] = torch.from_numpy(vals[0].view(np.int32)).to(dev)
    rv[0, :n] = torch.from_numpy(valid[0] & (lidx[0] < v_chunk)).to(dev)
    ops = (me, sh, st._replace(value=value), recv, rv, sp, spv)
    got = real(tmpl, plain, *ops)
    want = plain(*ops)
    torch.cuda.synchronize()
    assert torch.equal(bits(got[0].value), bits(want[0].value)), case
    assert torch.equal(got[0].frontier, want[0].frontier), case
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b), case
    for s, seq in zip(slots, seqs):
        assert int(bits(got[0].value)[0, s]) == np.int32(
            np.uint32(serial_min(seq))), (case, s)
