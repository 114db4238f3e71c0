"""The port's attention (``repro_torch.kernels.flash_attention``) against
the JAX package's Pallas ``flash_attention`` (interpret mode) and its
naive oracle ``attention_ref``, on the same inputs.

On the CPU, ``flash_attention`` and ``ops.attention`` run the kernel's
plain version (K/V repeated to H heads, then the blockwise scan).  The
cases are the reference's sweep (``tests/test_kernels.py:24-30``) and its
block-independence case, at its tolerances: 2e-5 in float32, 2e-2 in
bfloat16.  The CUDA kernel itself, and its wrapper's refusals, are tested
in ``tests/test_torch_flash_kernel.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention as j_flash
from repro.kernels.flash_attention.ref import attention_ref as j_ref
from repro_torch.kernels.flash_attention import (attention, attention_ref,
                                                 flash_attention,
                                                 repeat_kv_attention)
from repro_torch.models.layers import blockwise_attention
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

SWEEP = [
    (2, 256, 4, 2, 64, 0, "float32"),
    (1, 256, 4, 1, 64, 64, "float32"),
    (2, 128, 2, 2, 32, 0, "float32"),
    (1, 512, 8, 8, 64, 128, "float32"),
    (1, 256, 4, 4, 128, 0, "bfloat16"),
]


def inputs(B, S, H, Hkv, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(B, S, h, hd)).astype(np.float32)
            for h in (H, Hkv, Hkv)]
    jx = [jnp.asarray(a).astype(dtype) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def close(t, j, tol, what=""):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("B,S,H,Hkv,hd,win,dtype", SWEEP)
def test_plain_and_ops_match_pallas_and_ref(B, S, H, Hkv, hd, win, dtype):
    (jq, jk, jv), (tq, tk, tv) = inputs(B, S, H, Hkv, hd, dtype,
                                        seed=B * 1000 + S + H + hd + win)
    j_pallas = j_flash(jq, jk, jv, window=win)       # interpret mode
    j_naive = j_ref(jq, jk, jv, window=win)
    pos = torch.arange(S, dtype=torch.int32)
    tol = 2e-5 if dtype == "float32" else 2e-2
    outs = {"plain": repeat_kv_attention(tq, tk, tv, pos, win),
            "flash_attention": flash_attention(tq, tk, tv, win),
            "ops kernel": attention(tq, tk, tv, pos, win, use_kernel=True),
            "ops plain": attention(tq, tk, tv, pos, win, use_kernel=False),
            "attention_ref": attention_ref(tq, tk, tv, win)}
    for name, out in outs.items():
        assert out.dtype == tq.dtype and out.shape == tq.shape, name
        close(out, j_pallas, tol, f"{name} vs Pallas")
        close(out, j_naive, tol, f"{name} vs attention_ref")
    assert flash_attention.launches == 0   # CPU tensors: no launch


def test_block_shape_independence():
    """The blockwise scan gives the same attention for any block shape,
    and the Pallas kernel's at its block shapes."""
    (jq, jk, jv), (tq, tk, tv) = inputs(1, 256, 2, 2, 64, "float32", 0)
    pos = torch.arange(256, dtype=torch.int32)
    o1 = blockwise_attention(tq, tk, tv, pos, q_block=64, kv_block=128)
    o2 = blockwise_attention(tq, tk, tv, pos, q_block=256, kv_block=32)
    close(o1, o2.numpy(), 2e-5)
    close(o1, j_flash(jq, jk, jv, block_q=64, block_k=128), 2e-5)
    close(o2, j_flash(jq, jk, jv, block_q=256, block_k=32), 2e-5)
