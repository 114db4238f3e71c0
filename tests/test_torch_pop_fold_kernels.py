"""The unfused frontier pop and min fold over column-owning blocks:
``frontier_pop`` and ``fold_scatter(op="min")`` of
``repro_torch.kernels.engine.kernel``.

This file imports no JAX, so the card's machine runs it:
``python -m pytest -q -m cuda tests/test_torch_pop_fold_kernels.py``.  The
``cuda`` tests skip without a card.  Anywhere: the wrappers' launch
arguments (G and step from the column split, the min fold's path), with
the launch recorded instead of made, and the identity the pop's kernel
rests on: a block that knows how many set bits lie before its range,
capped at k, pops its own bits, so the ranges popped apart are the pop
of the whole bitmap.  Every comparison is bitwise.  ``pop_case`` and
``min_fold_case`` make the edge cases, which ``tests/test_torch_kernels.py``
also runs through the JAX package's ``frontier_pop`` and ``fold_scatter``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.engine import kernel as K
from repro_torch.kernels.engine.kernel import column_split, device_split
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

H100_SMS = 132
INF32 = np.float32(np.finfo(np.float32).max)


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def assert_same(got, want, where):
    """Every tensor of two results bitwise equal."""
    assert len(got) == len(want), where
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.dtype == b.dtype, (where, i)
        assert torch.equal(bits(a), bits(b)), (where, i)


def edges(T, n, sms, width=2):
    """The positions within ``width`` of every boundary of the column
    split of ``T`` tiles of ``n`` over ``sms`` SMs (its inner and outer
    ends), clipped to the tile."""
    bounds = np.array(column_split(T, n, sms).bounds(n))
    offs = np.arange(-width, width)
    return np.unique(np.clip(bounds[:, None] + offs, 0, n - 1))


# --------------------------------------------------------------------------
# The pop: edge cases
# --------------------------------------------------------------------------

# kind: (T, n, k_max)
POP_CASES = {
    "boundaries": (4, 2050, 32),     # G = 5: bits beside every boundary
    "straddle": (8, 4101, 32),       # the first k bits across a boundary
    "k 0, 1, k_max": (6, 4096, 32),
    "empty and full": (4, 4101, 32),
    "n % 16 == 5": (3, 4101, 16),    # G = 9, tiles off 16-byte vectors
    "n < 512": (5, 300, 8),          # G = 1
    "k_max 512": (4, 65536, 512),    # many bits a range, G = 5
}


def pop_case(kind: str, sms: int = H100_SMS):
    """numpy operands (mask (T, n) bool, k (T,) int32, k_max) of one edge
    case of the pop over ``sms`` SMs' column split."""
    T, n, k_max = POP_CASES[kind]
    rng = np.random.default_rng(list(POP_CASES).index(kind))
    dens = rng.choice([0.0005, 0.005, 0.05, 0.5], size=T)
    mask = rng.random((T, n)) < dens[:, None]
    k = rng.integers(0, k_max + 1, T)
    split = column_split(T, n, sms)
    if kind == "boundaries":
        mask[:] = False
        e = edges(T, n, sms)
        mask[:, e] = rng.random((T, e.size)) < 0.7
        k[:] = [1, k_max // 2, k_max, 3][:T]
    elif kind == "straddle":
        # tile t: k bits, half before boundary 1 + t % (G - 1), half after
        mask[:] = False
        for t in range(T):
            b = split.bounds(n)[1 + t % max(split.G - 1, 1)]
            kt = 1 + t % k_max if t % 2 else k_max
            before = kt // 2 + t % 2
            mask[t, b - before:b] = True
            mask[t, b:b + kt - before + t % 3] = True
            mask[t, b + 40:b + 80] = True   # later bits: not taken
            k[t] = kt
    elif kind == "k 0, 1, k_max":
        k[:] = [0, 1, k_max, 0, 1, k_max][:T]
    elif kind == "empty and full":
        mask[0] = False
        mask[1] = True
        mask[2] = True
        k[:] = [k_max, k_max, 0, 5][:T]
    return mask, k.astype(np.int32), k_max


def pop_by_ranges(mask, k, k_max, split):
    """The pop as the kernel's blocks make it, in numpy: block (t, g)
    counts the set bits before its range, capped at k (it stops counting
    once it reaches k), and pops its own bits from that count; the last
    range's block writes ``valid`` and the zeros of ``idx``."""
    T, n = mask.shape
    idx = np.full((T, k_max), -7, np.int32)     # unwritten: -7
    valid = np.zeros((T, k_max), bool)
    rem = mask.copy()
    bounds = split.bounds(n)
    for t in range(T):
        kt = int(k[t])
        for g in range(split.G):
            lo, hi = bounds[g], bounds[g + 1]
            seen = min(int(mask[t, :lo].sum()), max(kt, 0))
            if g == split.G - 1:
                n_take = max(0, min(kt, seen + int(mask[t, lo:hi].sum())))
                valid[t] = np.arange(k_max) < n_take
                idx[t, n_take:] = 0
            if seen >= kt:
                continue
            for p in np.flatnonzero(mask[t, lo:hi]) + lo:
                if seen >= kt:
                    break
                if seen < k_max:
                    idx[t, seen] = p
                rem[t, p] = False
                seen += 1
    return idx, valid, rem


@pytest.mark.parametrize("kind", list(POP_CASES))
def test_pop_by_ranges_is_the_pop(kind):
    """The identity the pop's kernel rests on: its column-owning blocks,
    each from the count of set bits before its range capped at k, give
    ``frontier_take``'s idx, valid and cleared mask, every slot of ``idx``
    written once."""
    mask, k, k_max = pop_case(kind)
    T, n = mask.shape
    split = column_split(T, n, H100_SMS)
    assert split.G > 1 or kind == "n < 512", split
    got = pop_by_ranges(mask, k, k_max, split)
    want = K.frontier_take(torch.from_numpy(mask), torch.from_numpy(k), k_max)
    for name, a, b in zip(("idx", "valid", "cleared"), got, want):
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)


# --------------------------------------------------------------------------
# The min fold: edge cases
# --------------------------------------------------------------------------

# kind: (T, v_chunk, R)
MIN_FOLD_CASES = {
    "boundaries": (2, 2050, 1024),   # G = 5, rows beside every boundary
    "signed zeros": (3, 2050, 3000),
    "float32 max targets": (2, 4101, 2000),
    "values equal to the target": (2, 2050, 2000),
    "all rows invalid": (3, 2050, 500),
    "one slot": (2, 2050, 600),
    "odd v_chunk": (3, 301, 2000),   # G = 1, v_chunk % 4 == 1
    "R-MAT-18": (64, 4096, 4096),    # the unfused R-MAT-18 paths' shape
}


def min_fold_case(kind: str, sms: int = H100_SMS):
    """numpy operands (target, lidx, vals, valid) of one min-fold edge
    case over ``sms`` SMs' column split.  Half the invalid rows lie on the
    trash slot v_chunk, half on a real slot, which they leave alone."""
    T, v, R = MIN_FOLD_CASES[kind]
    rng = np.random.default_rng(100 + list(MIN_FOLD_CASES).index(kind))
    tgt = np.where(rng.random((T, v)) < 0.3, INF32,
                   rng.normal(0, 20, (T, v))).astype(np.float32)
    valid = rng.random((T, R)) < 0.8
    lidx = rng.integers(0, v, (T, R))
    vals = rng.normal(0, 20, (T, R)).astype(np.float32)
    if kind == "boundaries":
        lidx = rng.choice(edges(T, v, sms), (T, R))
    elif kind == "signed zeros":
        z = np.float32([0.0, -0.0])
        tgt = np.where(rng.random((T, v)) < 0.5, rng.choice(z, (T, v)),
                       tgt).astype(np.float32)
        vals = np.where(rng.random((T, R)) < 0.6, rng.choice(z, (T, R)),
                        np.abs(vals)).astype(np.float32)
        lidx = rng.integers(0, 64, (T, R))        # many hits a slot
    elif kind == "float32 max targets":
        tgt[:] = INF32
        vals = np.where(rng.random((T, R)) < 0.3, INF32, vals)
    elif kind == "values equal to the target":
        vals = np.take_along_axis(tgt, lidx, 1).copy()
        vals[:, ::3] += 1.0
    elif kind == "all rows invalid":
        valid[:] = False
        vals[:] = -1e30
    elif kind == "one slot":
        lidx[:] = 1025
    lidx = np.where(valid | (rng.random((T, R)) < 0.5), lidx, v)
    return tgt, lidx.astype(np.int32), vals.astype(np.float32), valid


# --------------------------------------------------------------------------
# The launches: G, step and the path from the column split
# --------------------------------------------------------------------------

def record_launches(monkeypatch, wrapper, attrs):
    calls = []
    monkeypatch.setattr(K, "_check", lambda *operands: None)
    monkeypatch.setattr(K, "_launch", lambda fn, *args: calls.append(
        (fn, args)))
    monkeypatch.setattr(K, "device_split",
                        lambda nb, b, dev: column_split(nb, b, H100_SMS))
    for attr in ("launches", *attrs):
        monkeypatch.setattr(wrapper, attr, getattr(wrapper, attr))
    return calls


def meta(T, n, dtype):
    return torch.empty((T, n), dtype=dtype, device="meta")


@pytest.mark.parametrize("T,n,k_max,G", [
    (64, 65536, 32, 5),   # the R-MAT-22 partition: 320 blocks
    (64, 4096, 32, 5),    # R-MAT-18's
    (3, 4101, 16, 9),     # ragged n
    (5, 300, 8, 1),       # n < 512
    (257, 4096, 32, 2),   # T = 257
    (1, 65536, 65536, 128)])
def test_frontier_pop_launches_over_the_column_split(monkeypatch, T, n,
                                                      k_max, G):
    """The pop's CUDA branch (the launch recorded): its grid is the column
    split of the tiles' bitmaps, and the wrapper notes the split."""
    calls = record_launches(monkeypatch, K.frontier_pop, ("split",))
    before = K.frontier_pop.launches
    K.frontier_pop(meta(T, n, torch.bool),
                   torch.empty((T,), dtype=torch.int32, device="meta"), k_max)
    (fn, args), = calls
    assert fn == "repro_frontier_pop"
    assert len(args) == len(K.LIBRARY.signatures[fn]) - 1  # and the stream
    split = column_split(T, n, H100_SMS)
    assert [a for a in args if isinstance(a, int)] == [T, n, k_max, split.G,
                                                       split.step]
    assert K.frontier_pop.split == split and split.G == G
    assert K.frontier_pop.launches == before + 1


@pytest.mark.parametrize("T,v_chunk,R,G,path", [
    (64, 65536, 4096, 5, "staged in shared memory"),   # the timed shape
    (64, 4096, 4096, 5, "staged in shared memory"),    # R-MAT-18's
    (3, 4101, 2000, 9, "staged in shared memory"),     # ragged v_chunk
    (5, 300, 64, 1, "staged in shared memory"),        # v_chunk < 512
    (257, 4096, 16448, 2, "staged in shared memory"),
    (64, 262144, 4096, 5, "folded beside the copy"),   # step 52,432
    (64, 256000, 4096, 5, "staged in shared memory"),  # 204,800 bytes
    (64, 256004, 4096, 5, "folded beside the copy"),   # 204,816 bytes
    (1, 204804, 100, 264, "staged in shared memory")])
def test_min_fold_launches_over_the_column_split(monkeypatch, T, v_chunk, R,
                                                 G, path):
    """The min fold's CUDA branch (the launch recorded): its grid is the
    column split of the slices; a range of more than STAGE_SMEM_MAX bytes
    folds beside its copy, and the wrapper notes the split and the path."""
    calls = record_launches(monkeypatch, K.fold_scatter, ("split", "path"))
    K.fold_scatter(meta(T, v_chunk, torch.float32), meta(T, R, torch.int32),
                   meta(T, R, torch.float32), meta(T, R, torch.bool))
    (fn, args), = calls
    assert fn == "repro_fold_scatter_min"
    assert len(args) == len(K.LIBRARY.signatures[fn]) - 1
    split = column_split(T, v_chunk, H100_SMS)
    assert [a for a in args if isinstance(a, int)] == [T, v_chunk, R,
                                                       split.G, split.step]
    assert K.fold_scatter.split == split and split.G == G
    assert K.fold_scatter.path == path == K.min_fold_path(split.step)
    assert (path == "staged in shared memory") == (
        4 * split.step <= K.STAGE_SMEM_MAX)


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

def unaligned(x: torch.Tensor, offset_bytes: int) -> torch.Tensor:
    """A contiguous copy of ``x`` that starts ``offset_bytes`` past a
    16-byte boundary (a view into a larger buffer)."""
    n = x.numel() * x.element_size()
    buf = torch.empty(n + 16, dtype=torch.uint8, device=x.device)
    assert buf.data_ptr() % 16 == 0
    view = buf[offset_bytes:offset_bytes + n].view(x.dtype).view(x.shape)
    view.copy_(x)
    return view


def pop_on_card(dev, kind):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mask, k, k_max = pop_case(kind, sms)
    return torch.from_numpy(mask).to(dev), torch.from_numpy(k).to(dev), k_max


def check_pop(mask, k, k_max, where):
    before = K.frontier_pop.launches
    got = K.frontier_pop(mask, k, k_max)
    torch.cuda.synchronize()
    assert K.frontier_pop.launches == before + 1
    T, n = mask.shape
    assert K.frontier_pop.split == device_split(T, n, mask.device)
    assert_same(got, K.frontier_take(mask, k, k_max), where)
    assert_same(K.frontier_pop(mask, k, k_max), got, f"{where} again")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(POP_CASES))
def test_frontier_pop_kernel_bitwise_at_split_edges(kind):
    """The pop over the card's column split, bitwise its plain version
    (``frontier_take``), twice."""
    dev = card()
    check_pop(*pop_on_card(dev, kind), kind)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 5, 8, 15])
@pytest.mark.parametrize("kind", ["boundaries", "n % 16 == 5"])
def test_frontier_pop_kernel_bitwise_on_unaligned_views(kind, offset):
    """A bitmap that starts off a 16-byte vector (its cleared copy, a new
    tensor, does start on one): every vector read and written byte by
    byte where the two disagree."""
    dev = card()
    mask, k, k_max = pop_on_card(dev, kind)
    check_pop(unaligned(mask, offset), k, k_max, f"{kind} +{offset}")


@pytest.mark.cuda
@pytest.mark.parametrize("T,n", [(64, 65536), (64, 4096)])
def test_frontier_pop_kernel_bitwise_at_path_shapes(T, n):
    """The R-MAT-22 and R-MAT-18 partitions' bitmaps, budgets of 0, 1,
    k_max and between, densities from empty to full."""
    dev = card()
    rng = np.random.default_rng(n)
    mask = rng.random((T, n)) < rng.choice(
        [0.0, 0.0001, 0.001, 0.02, 0.3, 1.0], T)[:, None]
    k = rng.integers(0, 33, T).astype(np.int32)
    k[:4] = [0, 1, 32, 32]
    check_pop(torch.from_numpy(mask).to(dev), torch.from_numpy(k).to(dev),
              32, f"{T} x {n}")


def check_min_fold(args, where):
    before = K.fold_scatter.launches
    got = K.fold_scatter(*args)
    torch.cuda.synchronize()
    assert K.fold_scatter.launches == before + 1
    T, v_chunk = args[0].shape
    split = device_split(T, v_chunk, args[0].device)
    assert K.fold_scatter.split == split
    assert K.fold_scatter.path == K.min_fold_path(split.step)
    assert_same([got], [K.scatter_body(*args, "min")], where)
    assert_same([K.fold_scatter(*args)], [got], f"{where} again")
    return K.fold_scatter.path


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(MIN_FOLD_CASES))
def test_min_fold_kernel_bitwise_at_split_edges(kind):
    """The min fold over the card's column split, bitwise its plain
    version (``scatter_body(..., "min")``), twice."""
    dev = card()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    args = [torch.from_numpy(a).to(dev) for a in min_fold_case(kind, sms)]
    assert check_min_fold(args, kind) == "staged in shared memory"


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [4, 8, 12])
def test_min_fold_kernel_bitwise_on_unaligned_views(offset):
    """A target that starts off a 16-byte vector: the bulk copy takes the
    aligned part of each range, the ends are read one slot at a time, and
    the output (a new tensor) is written slot by slot."""
    dev = card()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tgt, *rest = [torch.from_numpy(a).to(dev)
                  for a in min_fold_case("boundaries", sms)]
    check_min_fold([unaligned(tgt, offset), *rest], f"+{offset} bytes")


@pytest.mark.cuda
@pytest.mark.parametrize("T,v_chunk,R,path", [
    (64, 65536, 4096, "staged in shared memory"),
    (64, 256000, 4096, "staged in shared memory"),
    (64, 262144, 4096, "folded beside the copy")])
def test_min_fold_kernel_bitwise_at_path_shapes(T, v_chunk, R, path):
    """The R-MAT-22 partition's fold (4,096 rows a tile, a quarter of
    them on one slot); slices of 256,000 slots, whose ranges of 51,200
    slots fill STAGE_SMEM_MAX; and of 262,144, whose ranges of 52,432
    pass it: folded beside the copy."""
    dev = card()
    rng = np.random.default_rng(v_chunk)
    tgt = np.where(rng.random((T, v_chunk)) < 0.5, INF32,
                   rng.integers(0, 30, (T, v_chunk))).astype(np.float32)
    valid = rng.random((T, R)) < 0.8
    lidx = rng.integers(0, v_chunk, (T, R))
    lidx[:, :R // 4] = 3
    lidx = np.where(valid, lidx, v_chunk).astype(np.int32)
    vals = rng.normal(10, 12, (T, R)).astype(np.float32)
    args = [torch.from_numpy(a).to(dev) for a in (tgt, lidx, vals, valid)]
    assert check_min_fold(args, f"{T} x {v_chunk}") == path
