"""The T2 scans ``edge_scan_gather`` and ``edge_scan_stream``: one kernel
body, a team of threads a message and four lanes a thread over a
grid-stride loop, which writes ``jvalid`` whole and ``nb``, ``w`` only for
the groups of four lanes that hold a live lane (``j`` below a valid
message's length).  Its outputs and the plain versions' (``segment_gather``,
``segment_stream``) agree under ``scan_contract``: all three, with ``nb``
and ``w`` set to 0 where ``jvalid`` is false.

This file imports no JAX, so the card's machine runs it:
``python -m pytest -q -m cuda tests/test_torch_scan_kernels.py``.
Anywhere: ``scan_contract`` and the wrappers' launch arguments (the launch
recorded instead of made), R * max_t2 past the earlier design's grid
included.  On the card (``cuda``): each scan against its plain version by
``scan_contract`` on max_t2 not a multiple of 4, R = 1, shards shorter than
max_t2, windows past what fused leg 1 stages, negative lengths, operands
off a 16-byte boundary and 19.2 M lanes, and the lanes a consumer reads
bitwise.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.engine import kernel as K
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

F32, I32, BOOL = torch.float32, torch.int32, torch.bool


def scan_operands(rng, T, e_chunk, R, max_t2, negative=False, dev="cpu"):
    """Half the messages valid, lengths uniform in [0, max_t2] (with
    ``negative``, a quarter below 0), the invalid messages' starts half -1
    (as ``chip_smoke.scan_inputs``)."""
    ed = rng.integers(-1, 1 << 22, (T, e_chunk)).astype(np.int32)
    ev = rng.uniform(1, 10, (T, e_chunk)).astype(np.float32)
    start = rng.integers(0, T * e_chunk, (T, R)).astype(np.int32)
    stop = start + rng.integers(0, max_t2 + 1, (T, R)).astype(np.int32)
    if negative:
        stop = np.where(rng.random((T, R)) < 0.25,
                        start - rng.integers(1, 9, (T, R)), stop)
    rv = rng.random((T, R)) < 0.5
    start = np.where(rv | (rng.random((T, R)) < 0.5), start, -1)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (ed, ev, start.astype(np.int32), stop.astype(np.int32),
                      rv)]


def bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def assert_contract(got, want, where):
    for i, (a, b) in enumerate(zip(K.scan_contract(got),
                                   K.scan_contract(want))):
        assert a.shape == b.shape and a.dtype == b.dtype, (where, i)
        assert torch.equal(bits(a), bits(b)), (where, i)


def test_scan_contract_masks_only_the_invalid_lanes():
    """scan_contract keeps jvalid and every valid lane's nb and w, and
    sets the other lanes of nb and w to 0 (+0.0): so two scans that differ
    only where jvalid is false agree under it, and two that differ on a
    valid lane do not."""
    rng = np.random.default_rng(0)
    args = scan_operands(rng, 3, 50, 20, 7)
    nb, w, jv = K.segment_gather(*args, 7)
    assert 0 < int(jv.sum()) < jv.numel()
    cnb, cw, cjv = K.scan_contract((nb, w, jv))
    assert torch.equal(cjv, jv)
    assert torch.equal(cnb[jv], nb[jv]) and torch.equal(bits(cw[jv]),
                                                         bits(w[jv]))
    assert not bool(cnb[~jv].any())
    assert torch.equal(bits(cw[~jv]), torch.zeros_like(bits(cw[~jv])))
    junk = (torch.where(jv, nb, -7), torch.where(jv, w, float("nan")), jv)
    assert_contract(junk, (nb, w, jv), "don't-care lanes")
    off = w.clone()
    off[tuple(jv.nonzero()[0].tolist())] += 1.0
    with pytest.raises(AssertionError):
        assert_contract((nb, off, jv), (nb, w, jv), "a valid lane")


@pytest.fixture
def launches(monkeypatch):
    """The scans' CUDA branch on meta tensors, the launch recorded."""
    calls = []
    monkeypatch.setattr(K, "_check", lambda *operands: None)
    monkeypatch.setattr(K, "_launch", lambda fn, *a: calls.append((fn, a)))
    for w in (K.edge_scan_gather, K.edge_scan_stream):
        monkeypatch.setattr(w, "launches", w.launches)
    return calls


def meta(*shape, dtype=I32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("T,R,max_t2", [(64, 1024, 32), (1, 600000, 32),
                                        (2, 1, 33), (3, 7, 6)])
def test_scans_launch_one_kernel_at_any_lane_count(launches, T, R, max_t2):
    """Each scan launches its own kernel once, with its outputs (T, R,
    max_t2) and the sizes; no R * max_t2 is refused (600,000 x 32 lanes
    passes the 65,535 blocks of 256 lanes of the earlier design's grid),
    and the stream passes its window for the entry's check."""
    e_chunk = 9000
    ops = (meta(T, e_chunk), meta(T, e_chunk, dtype=F32), meta(T, R),
           meta(T, R), meta(T, R, dtype=BOOL))
    out = K.edge_scan_gather(*ops, max_t2)
    out2 = K.edge_scan_stream(*ops, max_t2, 4 * max_t2)
    (f1, a1), (f2, a2) = launches
    assert (f1, f2) == ("repro_edge_scan_gather", "repro_edge_scan_stream")
    types = K.LIBRARY.signatures
    assert len(a1) == len(types[f1]) - 1 and len(a2) == len(types[f2]) - 1
    # the state's rows, then the shard's tiles: the same T for one run
    assert a1[8:] == (T, T, e_chunk, R, max_t2)
    assert a2[8:] == (T, T, e_chunk, R, max_t2, 4 * max_t2)
    for o, args in ((out, a1), (out2, a2)):
        assert all(a is b for a, b in zip(args[5:8], o))
        assert [x.dtype for x in o] == [I32, F32, BOOL]
        assert all(tuple(x.shape) == (T, R, max_t2) for x in o)
    assert K.edge_scan_gather.launches == K.edge_scan_stream.launches


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def unaligned(x, offset_elems=1):
    """A contiguous copy of x starting ``offset_elems`` elements past its
    allocation (off a 16-byte boundary)."""
    buf = torch.empty(x.numel() + offset_elems, dtype=x.dtype,
                      device=x.device)
    return buf[offset_elems:].view(x.shape).copy_(x)


# (T, e_chunk, R, max_t2): the main shape, max_t2 not a multiple of 4,
# R = 1, shards shorter than max_t2, one team of many groups
SCAN_CASES = [(64, 39134, 1024, 32), (2, 64, 10, 7), (3, 200, 30, 33),
              (2, 50, 17, 6), (1, 70, 1, 32), (2, 5, 12, 16),
              (3, 20, 40, 33), (2, 3000, 9, 1030), (2, 40, 9, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["plain", "negative", "unaligned"])
@pytest.mark.parametrize("case", SCAN_CASES)
def test_edge_scan_gather_kernel_under_contract(case, kind):
    """edge_scan_gather's kernel against segment_gather by scan_contract,
    and jvalid against the lanes that are valid by definition."""
    dev = card()
    T, e_chunk, R, mt = case
    args = scan_operands(np.random.default_rng(R), T, e_chunk, R, mt,
                         kind == "negative", dev)
    if kind == "unaligned":
        args = [unaligned(a) for a in args]
    before = K.edge_scan_gather.launches
    got = K.edge_scan_gather(*args, mt)
    torch.cuda.synchronize()
    assert K.edge_scan_gather.launches == before + 1
    assert_contract(got, K.segment_gather(*args, mt), f"{case} {kind}")


@pytest.mark.cuda
@pytest.mark.parametrize("mult", [1, 2, 16, "past the fused staging"])
@pytest.mark.parametrize("case", SCAN_CASES[1:8])
def test_edge_scan_stream_kernel_under_contract(case, mult):
    """edge_scan_stream's kernel against segment_stream by scan_contract at
    windows of 1, 2 and 16 times max_t2 and one past STREAM_MAX_WINDOW,
    shards shorter than two windows included."""
    dev = card()
    T, e_chunk, R, mt = case
    window = K.STREAM_MAX_WINDOW + 1 if isinstance(mult, str) \
        else mult * mt
    args = scan_operands(np.random.default_rng(e_chunk), T, e_chunk, R, mt,
                         True, dev)
    got = K.edge_scan_stream(*args, mt, window)
    torch.cuda.synchronize()
    assert_contract(got, K.segment_stream(*args, mt, window),
                    f"{case} window {window}")


@pytest.mark.cuda
def test_scans_past_the_earlier_grid():
    """600,000 messages of max_t2 = 32 on one tile (19.2 M lanes, past the
    65,535 x 256 lanes the earlier design's grid held): both scans under
    the contract."""
    dev = card()
    args = scan_operands(np.random.default_rng(1), 1, 70000, 600000, 32,
                         True, dev)
    assert_contract(K.edge_scan_gather(*args, 32),
                    K.segment_gather(*args, 32), "gather")
    assert_contract(K.edge_scan_stream(*args, 32, 32),
                    K.segment_stream(*args, 32, 32), "stream")
    torch.cuda.synchronize()
