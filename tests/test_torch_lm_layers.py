"""The port's LM layers (``repro_torch.models.layers``) against the JAX
package's (``repro.models.layers``) on the same inputs.

Inputs are made with numpy from a seed and fed to both packages.  Float32
cases agree within 1e-5 (the two sum in different orders); bfloat16 cases
within 2e-2, the reference's bfloat16 tolerance (``tests/test_kernels.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

DTYPES = ("float32", "bfloat16")
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def pair(a, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    t = torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))
    return j, t


def close(j, t, dtype, what=""):
    assert str(t.dtype) == f"torch.{jnp.dtype(j.dtype).name}", (what, t.dtype)
    tol = TOL[dtype]
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)) * 3
    scale = rng.normal(size=(64,))
    jx, tx = pair(x, dtype)
    js, ts = jnp.asarray(scale, jnp.float32), torch.from_numpy(
        scale.astype(np.float32))
    close(JL.rms_norm(jx, js, 1e-5), TL.rms_norm(tx, ts, 1e-5), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("positions", ["sequence", "per_batch"])
def test_rope(dtype, positions):
    """Half-split rotation; positions (S,) as a prefill's and (B, 1) as a
    decode step's, at a position past 2**10 (float32 angles)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 6, 3, 32))
    if positions == "sequence":
        pos = np.arange(6, dtype=np.int32)
    else:
        x = x[:, :1]
        pos = np.array([[5], [1500]], np.int32)
    jx, tx = pair(x, dtype)
    close(JL.rope(jx, jnp.asarray(pos), 1e4),
          TL.rope(tx, torch.from_numpy(pos), 1e4), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["swiglu", "squared_relu", "gelu"])
def test_mlp_apply(kind, dtype):
    rng = np.random.default_rng(2)
    d, ff = 32, 96
    x = rng.normal(size=(2, 5, d))
    jx, tx = pair(x, dtype)
    names = ("w_gate", "w_up", "w_down") if kind == "swiglu" \
        else ("w_up", "w_down")
    jp, tp = {}, {}
    for n in names:
        shape = (ff, d) if n == "w_down" else (d, ff)
        jp[n], tp[n] = pair(rng.normal(size=shape) / np.sqrt(shape[0]),
                            dtype)
    close(JL.mlp_apply(jp, jx, kind), TL.mlp_apply(tp, tx, kind), dtype,
          kind)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("G", [1, 2])
def test_decode_attention(G, window, dtype):
    """One query against a ring cache holding empty (-1) slots."""
    rng = np.random.default_rng(3)
    B, C, Hkv, hd = 2, 8, 2, 16
    q = rng.normal(size=(B, 1, Hkv * G, hd))
    k = rng.normal(size=(B, C, Hkv, hd))
    v = rng.normal(size=(B, C, Hkv, hd))
    cpos = np.array([[0, 1, 2, 3, 4, 5, -1, -1],
                     [8, 9, 10, 11, 12, 5, 6, 7]], np.int32)
    qpos = np.array([5, 12], np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (pair(a, dtype) for a in (q, k, v))
    close(JL.decode_attention(jq, jk, jv, jnp.asarray(cpos),
                              jnp.asarray(qpos), window),
          TL.decode_attention(tq, tk, tv, torch.from_numpy(cpos),
                              torch.from_numpy(qpos), window), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S,G,window,qb,kb", [
    (16, 1, 0, 512, 512),   # one block
    (32, 2, 0, 8, 16),      # several q and kv blocks, GQA
    (32, 4, 6, 16, 8),      # window inside a block
])
def test_blockwise_attention(S, G, window, qb, kb, dtype):
    rng = np.random.default_rng(4)
    B, Hkv, hd = 2, 2, 16
    q = rng.normal(size=(B, S, Hkv * G, hd))
    k = rng.normal(size=(B, S, Hkv, hd))
    v = rng.normal(size=(B, S, Hkv, hd))
    pos = np.arange(S, dtype=np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (pair(a, dtype) for a in (q, k, v))
    close(JL.blockwise_attention(jq, jk, jv, jnp.asarray(pos), window, qb,
                                 kb),
          TL.blockwise_attention(tq, tk, tv, torch.from_numpy(pos), window,
                                 qb, kb), dtype)


def test_matmul_f32_accumulates_bf16_in_f32_and_keeps_global_state():
    """bfloat16 operands: the product equals the float32 product of the
    same values (each bf16 x bf16 product is exact in float32, the sum is
    float32), as the reference's preferred_element_type=float32, and the
    cuBLAS reduced-precision flag is neither read nor changed."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.normal(size=(3, 7, 256)).astype(np.float32)) \
        .bfloat16()
    w = torch.from_numpy(rng.normal(size=(256, 4, 8)).astype(np.float32)) \
        .bfloat16()
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    y = TL.matmul_f32(a, w)
    assert y.dtype == torch.float32 and y.shape == (3, 7, 4, 8)
    want = (a.float().reshape(-1, 256) @ w.float().reshape(256, -1)) \
        .reshape(3, 7, 4, 8)
    assert torch.equal(y, want)
    # JAX's bf16 x bf16 einsum with float32 accumulation agrees
    j = jnp.einsum("bsd,dhk->bshk", jnp.asarray(a.float().numpy(),
                                                jnp.bfloat16),
                   jnp.asarray(w.float().numpy(), jnp.bfloat16),
                   preferred_element_type=jnp.float32)
    np.testing.assert_allclose(y.numpy(), np.asarray(j), rtol=1e-5,
                               atol=1e-4)
    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
        == flag
    assert jax.devices()[0].platform == "cpu"
