"""The port's kernel plain versions and queue/routing ops == the JAX
package's, bit for bit, on every output element.

Inputs are made with numpy from a seed and fed to both packages.  The
JAX side runs the Pallas kernels in interpret mode, ``jax.vmap``-ed over
a tile axis (the reference's LocalComm form); the port's wrappers get CPU
tensors and so run their plain versions.  Both implement the same pure
bodies, so even the don't-care slots (zeros in invalid ``idx``, stale
queue rows, clamped gathers in invalid lanes) must agree.  The sweeps are
those of ``tests/test_backend_pallas.py``: ragged tails, empty and full
frontiers, k=0, cap-0 queues, overflow drops, duplicate indices and
all-invalid rows.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import queues as jq
from repro.core.comm import LocalComm as JLocalComm
from repro.core.program import take_first_k as j_take_first_k
from repro.core.routing import bin_by_owner as j_bin_by_owner
from repro.kernels.engine import (edge_scan_gather as j_edge_scan_gather,
                                  fold_scatter as j_fold_scatter,
                                  frontier_pop as j_frontier_pop,
                                  queue_push_pop as j_queue_push_pop)
from repro_torch.core import queues as tq
from repro_torch.core.comm import LocalComm as TLocalComm
from repro_torch.core.program import take_first_k as t_take_first_k
from repro_torch.core.routing import bin_by_owner as t_bin_by_owner
from repro_torch.kernels.engine import (KERNELS, edge_scan_gather,
                                        fold_scatter, fold_scatter_add,
                                        frontier_pop, queue_push_pop, tally)

from test_torch_fold_kernels import ADD_FOLD_CASES, add_fold_case

pytestmark = pytest.mark.torch_port

INF32 = np.float32(np.finfo(np.float32).max)


def same(j, t, what=""):
    """Bitwise equality of a JAX array and a torch tensor."""
    a, b = np.asarray(j), t.numpy()
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b, err_msg=what)


def t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------
# frontier_pop (T4)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,k,k_max", [
    (8, 3, 8), (32, 0, 8), (32, 8, 8),   # partial / zero / exact budget
    (257, 100, 16),                      # ragged width, clamped to k_max
    (64, 5, 16), (16, 16, 16),           # odd width / full pop
])
def test_frontier_pop_matches_pallas(n, k, k_max):
    rng = np.random.default_rng(n * 31 + k)
    # tiles: empty / sparse / dense / full frontiers, per-tile budgets
    dens = np.array([0.0, 0.3, 0.7, 1.0])
    mask = rng.random((4, n)) < dens[:, None]
    ks = np.array([min(k, k_max), min(k, k_max), 0, min(k, k_max)],
                  np.int32)
    ji, jv, jm = jax.vmap(lambda m, kk: j_frontier_pop(m, kk, k_max))(
        jnp.asarray(mask), jnp.asarray(ks))
    with tally() as launches:
        ti, tv, tm = frontier_pop(t(mask), t(ks), k_max)
    assert launches.n == 1
    same(ji, ti, "idx")
    same(jv, tv, "valid")
    same(jm, tm, "cleared mask")


def test_take_first_k_twin_matches_xla_and_kernel():
    """The "torch" twin equals the reference's XLA take_first_k in full;
    against the kernel it agrees wherever idx is valid."""
    rng = np.random.default_rng(0)
    mask = rng.random((5, 48)) < 0.25
    ks = np.array([0, 1, 4, 8, 8], np.int32)
    ji, jv, jm = jax.vmap(lambda m, kk: j_take_first_k(m, kk, 8))(
        jnp.asarray(mask), jnp.asarray(ks))
    ti, tv, tm = t_take_first_k(t(mask), t(ks), 8)
    same(ji, ti, "idx")
    same(jv, tv, "valid")
    same(jm, tm, "mask")
    ki, kv, km = frontier_pop(t(mask), t(ks), 8)
    assert torch.equal(kv, tv) and torch.equal(km, tm)
    assert torch.equal(torch.where(kv, ki, 0), torch.where(tv, ti, 0))


# --------------------------------------------------------------------------
# queue_push_pop / queue_push / queue_take_front
# --------------------------------------------------------------------------

QUEUE_CASES = [
    (16, 3, 8, 4, 6, 14),    # near-full: push overflows -> drops
    (8, 2, 8, 8, 8, 0),      # empty queue, pop the whole fresh batch
    (8, 2, 6, 3, 4, 7),      # ragged: pop less than occupancy
    (32, 4, 1, 0, 8, 3),     # zero pop budget (TSU throttled the channel)
    (64, 2, 1, 64, 64, 40),  # update-channel shape: one empty fresh row
]


def queue_inputs(cap, w, nrows, pop, prefill, tiles=3, seed=0):
    """Per-tile queues with live rows and stale rows past the count (as
    the engine leaves them), fresh rows, validity and pop budgets."""
    rng = np.random.default_rng(seed + cap * 7 + nrows)
    data = rng.integers(-5, 99, (tiles, cap, w)).astype(np.int32)
    count = np.minimum(np.array([prefill, cap, 0][:tiles]), cap) \
        .astype(np.int32)
    rows = rng.integers(0, 99, (tiles, nrows, w)).astype(np.int32)
    valid = rng.random((tiles, nrows)) < 0.7
    valid[1] = True                      # a tile offering a full batch
    pops = np.array([pop, max(pop - 1, 0), pop][:tiles], np.int32)
    return data, count, rows, valid, pops


@pytest.mark.parametrize("cap,w,nrows,pop,max_n,prefill", QUEUE_CASES)
def test_queue_push_pop_matches_pallas(cap, w, nrows, pop, max_n, prefill):
    data, count, rows, valid, pops = queue_inputs(cap, w, nrows, pop,
                                                  prefill)
    jout = jax.vmap(functools.partial(j_queue_push_pop, max_n=max_n))(
        jnp.asarray(data), jnp.asarray(count), jnp.asarray(rows),
        jnp.asarray(valid), jnp.asarray(pops))
    tout = queue_push_pop(t(data), t(count), t(rows), t(valid), t(pops),
                          max_n)
    for name, a, b in zip(("taken", "tvalid", "data", "count", "drops"),
                          jout, tout):
        same(a, b, name)


def test_queue_push_pop_cap0_early_out():
    """A cap-0 queue stores nothing and launches nothing; every offered
    row is a drop (the reference's explicit early-out)."""
    rows = np.ones((2, 3, 2), np.int32)
    valid = np.array([[True, False, True], [True, True, True]])
    data = np.zeros((2, 0, 2), np.int32)
    count = np.zeros(2, np.int32)
    pops = np.array([4, 0], np.int32)
    jout = jax.vmap(functools.partial(j_queue_push_pop, max_n=4))(
        jnp.asarray(data), jnp.asarray(count), jnp.asarray(rows),
        jnp.asarray(valid), jnp.asarray(pops))
    with tally() as launches:
        tout = queue_push_pop(t(data), t(count), t(rows), t(valid), t(pops),
                              4)
    assert launches.n == 0
    for name, a, b in zip(("taken", "tvalid", "data", "count", "drops"),
                          jout, tout):
        same(a, b, name)


@pytest.mark.parametrize("cap,w,nrows,pop,max_n,prefill", QUEUE_CASES)
def test_queue_push_and_take_front_match_xla(cap, w, nrows, pop, max_n,
                                             prefill):
    """The "torch" queue pair equals the reference's XLA pair on every
    element, stale rows of the kept buffer included."""
    data, count, rows, valid, pops = queue_inputs(cap, w, nrows, pop,
                                                  prefill, seed=1)

    def jpair(d, c, r, v, n):
        q, drop = jq.queue_push(jq.Queue(d, c), r, v)
        taken, tv, q = jq.queue_take_front(q, n, max_n)
        return q.data, q.count, drop, taken, tv

    jout = jax.vmap(jpair)(jnp.asarray(data), jnp.asarray(count),
                           jnp.asarray(rows), jnp.asarray(valid),
                           jnp.asarray(pops))
    q, drop = tq.queue_push(tq.Queue(t(data), t(count)), t(rows), t(valid))
    taken, tv, q = tq.queue_take_front(q, t(pops), max_n)
    for name, a, b in zip(("data", "count", "drops", "taken", "tvalid"),
                          jout, (q.data, q.count, drop, taken, tv)):
        same(a, b, name)


# --------------------------------------------------------------------------
# edge_scan_gather (T2)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("e_chunk,r,max_t2", [(64, 10, 8), (128, 1, 16),
                                              (33, 24, 4)])
def test_edge_scan_gather_matches_pallas(e_chunk, r, max_t2):
    rng = np.random.default_rng(e_chunk + r)
    tiles = 2
    ed = rng.integers(-1, 100, (tiles, e_chunk)).astype(np.int32)
    ev = rng.random((tiles, e_chunk)).astype(np.float32)
    start = rng.integers(0, 4 * e_chunk, (tiles, r)).astype(np.int32)
    # ragged tails: lengths 0..max_t2; some rows invalid, carrying the -1
    # empty-slot head flit the router leaves there
    stop = (start + rng.integers(0, max_t2 + 1, (tiles, r))).astype(np.int32)
    rv = rng.random((tiles, r)) < 0.75
    start = np.where(rv | (rng.random((tiles, r)) < 0.5), start, -1) \
        .astype(np.int32)
    jout = jax.vmap(lambda a, b, c, d, e: j_edge_scan_gather(
        a, b, c, d, e, max_t2))(*map(jnp.asarray, (ed, ev, start, stop, rv)))
    with tally() as launches:
        tout = edge_scan_gather(t(ed), t(ev), t(start), t(stop), t(rv),
                                max_t2)
    assert launches.n == 1
    for name, a, b in zip(("nb", "w", "jvalid"), jout, tout):
        same(a, b, name)


# --------------------------------------------------------------------------
# fold_scatter (T3)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["min", "add"])
@pytest.mark.parametrize("v_chunk,r", [(32, 20), (8, 64), (128, 1)])
def test_fold_scatter_matches_pallas(op, v_chunk, r):
    rng = np.random.default_rng(v_chunk * 3 + r)
    tiles = 3
    tgt = np.where(rng.random((tiles, v_chunk)) < 0.3, INF32,
                   rng.random((tiles, v_chunk))).astype(np.float32)
    # heavy duplicates + the v_chunk trash slot for invalid rows
    lidx_raw = rng.integers(0, max(v_chunk // 4, 1), (tiles, r))
    valid = rng.random((tiles, r)) < 0.6
    lidx = np.where(valid, lidx_raw, v_chunk).astype(np.int32)
    vals = rng.normal(size=(tiles, r)).astype(np.float32)
    jout = jax.vmap(lambda a, b, c, d: j_fold_scatter(a, b, c, d, op=op))(
        *map(jnp.asarray, (tgt, lidx, vals, valid)))
    tout = fold_scatter(t(tgt), t(lidx), t(vals), t(valid), op=op)
    same(jout, tout, f"fold {op}")


@pytest.mark.parametrize("kind", list(ADD_FOLD_CASES))
def test_fold_scatter_add_edge_cases_match_pallas(kind):
    """The add fold's edge cases of the column-owning kernel (rows beside
    every range boundary, v_chunk not a multiple of 4, -0.0 slots hit by
    invalid rows only, one slot hit by every row, rows past one and two
    sort chunks): the plain version bitwise the JAX package's
    ``fold_scatter(op="add")``."""
    tgt, lidx, vals, valid = add_fold_case(kind)
    jout = jax.vmap(lambda a, b, c, d: j_fold_scatter(a, b, c, d, op="add"))(
        *map(jnp.asarray, (tgt, lidx, vals, valid)))
    tout = fold_scatter_add(t(tgt), t(lidx), t(vals), t(valid))
    same(jout, tout, kind)


def test_fold_scatter_all_invalid_is_identity():
    tgt = np.float32([[1.0, INF32, 3.0, 4.0], [0.0, -2.0, INF32, 5.0]])
    lidx = np.full((2, 6), 4, np.int32)  # all trash
    vals = np.ones((2, 6), np.float32)
    valid = np.zeros((2, 6), bool)
    jout = jax.vmap(lambda a, b, c, d: j_fold_scatter(a, b, c, d))(
        *map(jnp.asarray, (tgt, lidx, vals, valid)))
    tout = fold_scatter(t(tgt), t(lidx), t(vals), t(valid))
    same(jout, tout)
    assert np.array_equal(tout.numpy(), tgt)


def test_cpu_calls_count_for_stats_not_as_cuda_launches():
    """On CPU tensors every wrapper call is recorded for Stats.launches,
    while the CUDA launch counters stay untouched."""
    before = [k.launches for k in KERNELS]
    mask = torch.zeros((2, 16), dtype=torch.bool)
    with tally() as launches:
        frontier_pop(mask, torch.zeros(2, dtype=torch.int32), 4)
        fold_scatter(torch.zeros((2, 4)), torch.full((2, 3), 4,
                                                     dtype=torch.int32),
                     torch.zeros((2, 3)), torch.zeros((2, 3), dtype=bool))
    assert launches.n == 2
    assert [k.launches for k in KERNELS] == before


# --------------------------------------------------------------------------
# Routing ops: occurrence_index, bin_by_owner, LocalComm.a2a
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,num_dest", [(1, 1), (37, 4), (256, 16)])
def test_occurrence_index_and_bin_by_owner_match(n, num_dest):
    rng = np.random.default_rng(n + num_dest)
    tiles, w, cap = 3, 3, 4
    dest = rng.integers(0, num_dest, (tiles, n)).astype(np.int32)
    valid = rng.random((tiles, n)) < 0.8
    msgs = rng.integers(0, 1000, (tiles, n, w)).astype(np.int32)
    jocc = jax.vmap(lambda d, v: jq.occurrence_index(d, v, num_dest))(
        jnp.asarray(dest), jnp.asarray(valid))
    same(jocc, tq.occurrence_index(t(dest), t(valid), num_dest), "occ")
    jb = jax.vmap(lambda m, v, d: j_bin_by_owner(m, v, d, num_dest, cap))(
        jnp.asarray(msgs), jnp.asarray(valid), jnp.asarray(dest))
    tb = t_bin_by_owner(t(msgs), t(valid), t(dest), num_dest, cap)
    for name, a, b in zip(("buf", "spill", "spill_valid", "sent"), jb, tb):
        same(a, b, name)
    jh = jax.vmap(lambda d, v: jq.histogram(d, v, num_dest))(
        jnp.asarray(dest), jnp.asarray(valid))
    same(jh, tq.histogram(t(dest), t(valid), num_dest), "histogram")


def test_local_comm_a2a_psum_pmax_match():
    rng = np.random.default_rng(3)
    T, s, w = 4, 3, 2
    x = rng.integers(-50, 50, (T, T * s, w)).astype(np.int32)
    jc, tc = JLocalComm(T), TLocalComm(T)
    same(jc.a2a(jnp.asarray(x)), tc.a2a(t(x)), "a2a")
    same(jc.psum(jnp.asarray(x)), tc.psum(t(x)), "psum")
    same(jc.pmax(jnp.asarray(x)), tc.pmax(t(x)), "pmax")
    f = rng.random(T).astype(np.float32)
    same(jc.to_global(jc.pmax(jnp.asarray(f))),
         tc.to_global(tc.pmax(t(f))), "pmax f32")


def test_f2i_i2f_are_bitcasts():
    vals = np.float32([0.0, -0.0, 1.5, INF32, -3.25, np.inf])
    same(jq.f2i(jnp.asarray(vals)), tq.f2i(t(vals)), "f2i")
    bits = np.int32([0, -1, 0x7F7FFFFF, 12345])
    same(jq.i2f(jnp.asarray(bits)), tq.i2f(t(bits)), "i2f")
