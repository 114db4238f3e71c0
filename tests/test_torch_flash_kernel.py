"""The flash-attention kernel's wrapper and, on a card, the kernel itself
against its plain version (``repro_torch.kernels.flash_attention``), with
the bfloat16 projections' float32 accumulation on the card.

This file imports no JAX, so the card's machine runs it:
``python -m pytest -q -m cuda tests/test_torch_flash_kernel.py``.  The
``cuda`` tests skip without a card; the refusals run anywhere, on ``meta``
tensors, which take the CUDA path's checks without one.  Tolerances: the
reference's (``tests/test_kernels.py:37``), 2e-5 in float32, 2e-2 in
bfloat16.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (attention, flash_attention,
                                                 repeat_kv_attention)
from repro_torch.models.layers import matmul_f32

pytestmark = pytest.mark.torch_port

SWEEP = [
    (2, 256, 4, 2, 64, 0, "float32"),
    (1, 256, 4, 1, 64, 64, "float32"),
    (2, 128, 2, 2, 32, 0, "float32"),
    (1, 512, 8, 8, 64, 128, "float32"),
    (1, 256, 4, 4, 128, 0, "bfloat16"),
    (1, 100, 4, 2, 64, 0, "float32"),      # S not a multiple of 64
    (2, 200, 8, 2, 64, 0, "float32"),      # one 200-row reference block
    (4, 2048, 32, 8, 64, 0, "bfloat16"),   # granite-3-2b's prefill
    (1, 256, 4, 4, 80, 0, "float32"),      # hd 80: 5 columns a thread
    (2, 200, 4, 2, 80, 64, "float32"),
    (1, 256, 4, 4, 80, 0, "bfloat16"),
    (4, 2048, 32, 32, 80, 0, "bfloat16"),  # zamba2-2.7b's prefill
    # bfloat16 runs on the tensor cores (TMA boxes of 64 rows and 32 or 64
    # columns, 128-row query blocks): S shorter than one box, ragged S,
    # every head width, windows 64 and 128 at G = 1, 4 and 8
    (1, 8, 4, 4, 64, 0, "bfloat16"),
    (2, 8, 8, 1, 80, 0, "bfloat16"),
    (1, 64, 4, 1, 64, 0, "bfloat16"),
    (2, 100, 8, 1, 128, 0, "bfloat16"),
    (2, 100, 4, 4, 32, 0, "bfloat16"),
    (2, 200, 8, 8, 32, 0, "bfloat16"),
    (2, 200, 8, 2, 80, 64, "bfloat16"),
    (1, 384, 8, 1, 32, 64, "bfloat16"),
    (1, 512, 8, 8, 128, 128, "bfloat16"),
    (1, 512, 8, 2, 80, 128, "bfloat16"),
    # window 64: the warpgroup of rows 128-191 computes kv tile 1 (keys
    # 64-127) for row 128, and row 191 has no live key there (likewise row
    # 255 in tile 2)
    (2, 256, 4, 1, 64, 64, "bfloat16"),
]


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """A non-CPU tensor takes the CUDA path, which checks every operand
    before any launch: dtype, shape, contiguity, head width, GQA grouping,
    the reference's block rule on S, the window and, last, the device."""
    q, kv = meta((2, 256, 8, 64)), meta((2, 256, 2, 64))
    with pytest.raises(TypeError):
        flash_attention(q.half(), kv.half(), kv.half())
    with pytest.raises(TypeError):
        flash_attention(q, kv.float(), kv)
    with pytest.raises(ValueError, match="shape"):
        flash_attention(q, meta((2, 128, 2, 64)), kv)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q, kv, meta((2, 2, 256, 64)).transpose(1, 2))
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(meta((2, 256, 8, 48)), meta((2, 256, 2, 48)),
                        meta((2, 256, 2, 48)))
    with pytest.raises(ValueError, match="kv heads"):
        flash_attention(q, meta((2, 256, 3, 64)), meta((2, 256, 3, 64)))
    with pytest.raises(ValueError, match="min"):   # 600 % 512 != 0
        flash_attention(meta((1, 600, 8, 64)), meta((1, 600, 2, 64)),
                        meta((1, 600, 2, 64)))
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, kv, kv, window=-1)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="positions"):
        attention(q, kv, kv, torch.arange(255), use_kernel=True)
    assert flash_attention.launches == 0


def test_wrapper_refuses_bfloat16_operands_tma_cannot_address():
    """The bfloat16 body reads q, k and v by TMA, which needs 16-byte
    aligned addresses: a view that starts 2 bytes in is refused before the
    device check; a float32 one (the FMA body) is not."""
    def off(shape, dtype=torch.bfloat16, by=1):
        n = int(np.prod(shape))
        return torch.empty(n + by, dtype=dtype,
                           device="meta")[by:].view(shape)
    q, kv = meta((2, 256, 8, 64)), meta((2, 256, 2, 64))
    for args in ((off(q.shape), kv, kv), (q, off(kv.shape), kv),
                 (q, kv, off(kv.shape))):
        with pytest.raises(ValueError, match="multiple of 16"):
            flash_attention(*args)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(off(q.shape, torch.float32), kv.float(), kv.float())
    assert flash_attention.launches == 0


@pytest.mark.parametrize("S", [200, 300, 1024, 2048])
def test_wrapper_takes_the_lengths_the_reference_prefill_takes(S):
    """An S that divides into blocks of min(512, S), as the reference's
    prefill (``blockwise_attention``) requires, passes every shape check
    and stops only at the device check."""
    q, kv = meta((1, S, 8, 64)), meta((1, S, 2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, kv, kv)
    assert flash_attention.launches == 0


@pytest.mark.parametrize("hd", [32, 64, 80, 128])
def test_wrapper_takes_every_head_width_it_has_an_instance_for(hd):
    """hd 32, 64 and 128 (the reference's sweep) and 80 (zamba2-2.7b,
    2560 / 32) pass every shape check, in both dtypes, and stop only at
    the device check."""
    for dtype in (torch.float32, torch.bfloat16):
        q = meta((4, 208, 32, hd), dtype)
        with pytest.raises(ValueError, match="CUDA"):
            flash_attention(q, q, q, window=4096)
    assert flash_attention.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hkv,hd,win,dtype", SWEEP)
def test_cuda_kernel_matches_plain(B, S, H, Hkv, hd, win, dtype):
    dev = card()
    rng = np.random.default_rng(S + hd)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, S, h, hd)).astype(
        np.float32)).to(dev, getattr(torch, dtype)) for h in (H, Hkv, Hkv))
    before = flash_attention.launches
    out = flash_attention(q, k, v, win)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    tol = 2e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(out.float(), repeat_kv_attention(
        q, k, v, pos, win).float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_cuda_bf16_projection_accumulates_in_f32():
    """On the card, matmul_f32 of bfloat16 operands sums in float32 (a
    sum rounded to bfloat16 would sit near bfloat16's rounding unit,
    2**-9, from the float32 product) and leaves the cuBLAS
    reduced-precision flag as it was."""
    dev = card()
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(1024, 2048, generator=gen, device=dev).bfloat16()
    w = (torch.randn(2048, 8192, generator=gen, device=dev) / 45).bfloat16()
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    y = matmul_f32(a, w)
    want = a.float() @ w.float()
    assert y.dtype == torch.float32
    assert float((y - want).norm() / want.norm()) < 1e-5
    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
        == flag
