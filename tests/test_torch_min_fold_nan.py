"""The port's min folds on NaN and signed zeros against the JAX package's:
the engine's ``scatter_body`` (and the wrapper ``fold_scatter`` on CPU
tensors) against the Pallas ``fold_scatter`` in interpret mode, whose body
is ``ext.at[lidx].min``; the block ``binned_scatter`` (and the wrapper
``scatter_segments`` on CPU tensors) against the Pallas
``scatter_segments``' min.  Compared on bits, NaN payloads included.

The cases: the two faults found in the port (a positive NaN dropped; the
signed zeros of ``binned_scatter``), the inputs that found the rule, and
``tests/test_torch_nan_fold_kernels.py``'s ``NAN_CASES``, which tell row
order from payload order.  The Pallas ``scatter_segments`` runs one bin a
call: its row reduction takes the rows in row order there, but not always
over several bins (ROADMAP §3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.engine import fold_scatter as j_fold_scatter
from repro.kernels.engine.kernel import scatter_body as j_scatter_body
from repro.kernels.scatter_update.kernel import scatter_segments as j_seg
from repro_torch.kernels.engine import fold_scatter, scatter_body
from repro_torch.kernels.scatter_update import (binned_scatter,
                                                scatter_segments)
from test_torch_nan_fold_kernels import (FMAX, NAN_CASES, M, N, NZ, PZ,
                                         as_bins, fold_case)
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

NAN = 0x7FC00000
F = np.float32


def f32(*u):
    return np.array(u, np.uint32).view(np.float32)


def hexes(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return [f"{v:08x}" for v in x.reshape(-1).view(np.uint32)]


def jax_fold(tgt, lidx, vals, valid):
    """The Pallas fold_scatter min over the tiles (interpret mode)."""
    return np.asarray(jax.vmap(
        lambda a, b, c, d: j_fold_scatter(a, b, c, d, op="min"))(
        *map(jnp.asarray, (tgt, lidx, vals, valid))))


def jax_seg(base, idx, vals):
    """The Pallas scatter_segments min, one bin a call."""
    return np.concatenate([np.asarray(j_seg(
        jnp.asarray(base[i:i + 1]), jnp.asarray(idx[i:i + 1]),
        jnp.asarray(vals[i:i + 1]), op="min")) for i in range(len(base))])


def port_fold(tgt, lidx, vals, valid):
    ts = [torch.from_numpy(np.ascontiguousarray(a))
          for a in (tgt, lidx, vals, valid)]
    out = scatter_body(*ts, "min")
    assert hexes(fold_scatter(*ts)) == hexes(out)
    return out


def port_seg(base, idx, vals):
    ts = [torch.from_numpy(np.ascontiguousarray(a))
          for a in (base, idx, vals)]
    out = binned_scatter(*ts, "min")
    assert hexes(scatter_segments(*ts, op="min")) == hexes(out)
    return out


# (target, lidx, vals) of one tile, all rows valid, lidx 4 the trash slot;
# the faults and the rule-finding cases, with what the JAX package gives
FAULTS = {
    "a positive NaN": (f32(0x3F800000, NAN, 0x40A00000, 0x40000000),
                       [0, 0, 1, 2, 3, 4],
                       f32(NAN, 0x3F000000, 0x40400000, NAN, 0x3F800000,
                           0), [NAN, NAN, NAN, 0x3F800000]),
    "a positive NaN, payload 1": (
        f32(0x3F800000, N(1), 0x40A00000, 0x40000000), [0, 0, 1, 2, 3, 4],
        f32(N(1), 0x3F000000, 0x40400000, N(1), 0x3F800000, 0),
        [N(1), N(1), N(1), 0x3F800000]),
    "a negative NaN wins too": (
        f32(0x3F800000, 0x3F800000, 0x40A00000, 0x40000000),
        [0, 0, 1, 2, 3, 4],
        f32(0xFFC00001, 0x3F000000, 0x40400000, 0xFFC00001, 0x3F800000, 0),
        [0xFFC00001, 0x3F800000, 0xFFC00001, 0x3F800000]),
    "case A": (f32(N(1), 0x3F800000, N(3), 0x3F800000), [0, 1, 1, 2, 3, 3],
               f32(N(2), N(4), N(5), 0x3F000000, M(6), N(7)),
               [N(1), N(4), N(3), N(7)]),
}


@pytest.mark.parametrize("case", sorted(FAULTS))
def test_min_fold_faults_give_the_jax_bits(case):
    """The faults found on the CPU, on one tile: the port's plain min fold
    gives the JAX package's bits, which are the issue's readings."""
    tgt, lidx, vals, want = FAULTS[case]
    ops = (tgt[None], np.int32(lidx)[None], vals[None],
           np.ones((1, len(lidx)), bool))
    assert hexes(jax_fold(*ops)) == [f"{w:08x}" for w in want]
    assert hexes(port_fold(*ops)) == hexes(jax_fold(*ops))
    assert hexes(j_scatter_body(*map(jnp.asarray, (tgt, np.int32(lidx),
                                                     vals, ops[3][0])),
                                "min")) == hexes(jax_fold(*ops))


def test_binned_scatter_signed_zeros_and_nan_give_the_pallas_bits():
    """``binned_scatter`` folded -0.0 and +0.0 by arrival order; the
    Pallas body gives -0.0 in all four slots, and now the port does.  Its
    NaN case (base 1.0, N1, 2.0, 3.0; a positive and a negative NaN on one
    slot; a row of float32 max, above the Pallas clamp, on a slot whose
    base is below it) gives N2, N1, N3, 3.0 on both."""
    base = f32(PZ, NZ, PZ, NZ)[None]
    idx = np.int32([[0, 1, 2, 3, 2, 3]])
    vals = f32(NZ, PZ, NZ, PZ, PZ, NZ)[None]
    assert hexes(jax_seg(base, idx, vals)) == ["80000000"] * 4
    assert hexes(port_seg(base, idx, vals)) == ["80000000"] * 4
    base = f32(0x3F800000, N(1), 0x40000000, 0x40400000)[None]
    idx = np.int32([[0, 0, 1, 2, 2, 3]])
    vals = f32(N(2), 0x3F000000, 0x3F000000, N(3), M(4), FMAX)[None]
    want = [f"{w:08x}" for w in (N(2), N(1), N(3), 0x40400000)]
    assert hexes(jax_seg(base, idx, vals)) == want
    assert hexes(port_seg(base, idx, vals)) == want


@pytest.mark.parametrize("case", sorted(NAN_CASES))
def test_min_folds_match_jax_on_nan_cases(case):
    """Every case of NAN_CASES over two tiles (the sequences in tile 0,
    with invalid rows carrying NaNs and -0.0 on real slots and on the
    trash slot): the port's scatter_body against the Pallas fold_scatter,
    and binned_scatter against the Pallas scatter_segments, bitwise."""
    ops, _ = fold_case(NAN_CASES[case], T=2, spread=3)
    assert hexes(port_fold(*ops)) == hexes(jax_fold(*ops))
    bins = below_clamp(*as_bins(*ops))
    assert hexes(port_seg(*bins)) == hexes(jax_seg(*bins))


def below_clamp(base, idx, vals):
    """scatter_segments operands with every number of magnitude above the
    Pallas body's clamp of 3.4e38 (ROADMAP §3: the port keeps the base
    there, as the oracle does) replaced: bases by 2.0, rows by 1.0."""
    def big(x):
        return ~np.isnan(x) & (np.abs(x) > 3.4e38)
    return (np.where(big(base), F(2), base), idx,
            np.where(big(vals), F(1), vals))


def test_min_folds_match_jax_on_drawn_nans():
    """Drawn folds, a sixth of the values positive NaNs, a sixth negative
    ones, a sixth ±0.0 or ±inf (payloads signalling and quiet), up to 300
    rows on up to 5 slots: bitwise the JAX package's, both folds."""
    rng = np.random.default_rng(26)
    for trial in range(40):
        T, v = 2, int(rng.integers(1, 6))
        R = int(rng.integers(0, 300 if trial % 8 == 0 else 24))

        def draw(shape):
            kind = rng.integers(0, 6, shape)
            u = np.where(kind == 0, 0x7F800001 + rng.integers(0, 0x7FFFFF,
                                                              shape),
                         np.where(kind == 1, 0xFF800001 + rng.integers(
                             0, 0x7FFFFF, shape),
                             np.where(kind == 2, rng.choice(
                                 [PZ, NZ, 0x7F800000, 0xFF800000], shape),
                                 rng.normal(0, 10, shape).astype(
                                     F).view(np.uint32))))
            return u.astype(np.uint32).view(F)

        tgt, vals = draw((T, v)), draw((T, R))
        lidx = rng.integers(0, v + 1, (T, R)).astype(np.int32)
        valid = rng.random((T, R)) < 0.85
        ops = (tgt, lidx, vals, valid)
        assert hexes(port_fold(*ops)) == hexes(jax_fold(*ops)), trial
        bins = below_clamp(*as_bins(*ops))
        assert hexes(port_seg(*bins)) == hexes(jax_seg(*bins)), trial
