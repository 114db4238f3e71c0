"""The flash-attention backward kernel's wrapper and, on a card, the
kernel against its plain version (``repro_torch.kernels.flash_attention``
``flash_attention_bwd``: autograd through ``repeat_kv_attention``), and
the training forward's logsumexp against its plain version.

This file imports no JAX, so the card's machine runs it:
``python -m pytest -q -m cuda tests/test_torch_flash_bwd_kernel.py``.
The ``cuda`` tests skip without a card; the refusals run anywhere, on
``meta`` tensors, which take the CUDA path's checks without one.
Tolerances: each gradient within 2e-5 (float32) or 2e-2 (bfloat16) of
its plain version's largest magnitude, the forward's tolerances scaled
by the gradient's size (the sums run in other orders); the logsumexp
within 1e-5 (float32) or 1e-3 (bfloat16: the wgmma body's running max
and sum are in log2 units) absolute.
"""
import pytest
import torch

from repro_torch.kernels.flash_attention import (attention_bwd_plain,
                                                 attention_lse,
                                                 flash_attention_bwd,
                                                 flash_attention_fwd)
from repro_torch.models.layers import matmul_f32, split_bf16
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port


def meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_backward_wrapper_refuses_what_the_kernel_does_not_take():
    """A non-CPU tensor takes the CUDA path, which checks every operand
    (the forward's checks, then out, dout and lse) before any launch."""
    q, kv = meta((2, 256, 8, 64)), meta((2, 256, 2, 64))
    lse = meta((2, 8, 256), torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_bwd(meta((2, 256, 8, 48)), meta((2, 256, 2, 48)),
                            meta((2, 256, 2, 48)), q, lse, q)
    with pytest.raises(ValueError, match="shape"):
        flash_attention_bwd(q, kv, kv, q, meta((2, 8, 128), torch.float32),
                            q)
    with pytest.raises(TypeError):
        flash_attention_bwd(q, kv, kv, q, lse.bfloat16(), q)
    with pytest.raises(TypeError):
        flash_attention_bwd(q, kv, kv, q.float(), lse, q)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_bwd(q, kv, kv, q,
                            lse, meta((2, 8, 256, 64)).transpose(1, 2))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd(q, kv, kv, q, lse, q)
    assert flash_attention_bwd.launches == 0


# --------------------------------------------------------------------------
# On a card: the backward kernel against its plain version
# --------------------------------------------------------------------------

# (B, S, H, Hkv, hd, window, dtype): G = 1, 2 and 4, S not a multiple of
# the 64-row tile, window 128, every head width
CUDA_CASES = [
    (2, 256, 4, 4, 64, 0, "float32"), (2, 256, 8, 2, 64, 0, "float32"),
    (1, 200, 8, 2, 64, 0, "float32"), (1, 512, 8, 2, 64, 128, "float32"),
    (1, 256, 4, 4, 32, 0, "float32"), (1, 256, 4, 4, 80, 0, "float32"),
    (1, 256, 4, 4, 128, 0, "float32"), (2, 256, 8, 2, 64, 0, "bfloat16"),
    (1, 512, 8, 8, 80, 128, "bfloat16")]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hkv,hd,win,dtype", CUDA_CASES)
def test_cuda_backward_kernel_matches_plain(B, S, H, Hkv, hd, win, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda", 0)
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(B, S, h, hd, generator=gen, device=dev).to(dt)
               for h in (H, Hkv, Hkv))
    do = torch.randn(B, S, H, hd, generator=gen, device=dev).to(dt)
    out, lse = flash_attention_fwd(q, k, v, win)
    got = flash_attention_bwd(q, k, v, out, lse, do, win)
    want = attention_bwd_plain(q, k, v, do, win)
    tol = 2e-5 if dtype == "float32" else 2e-2
    lse_tol = 1e-5 if dtype == "float32" else 1e-3
    assert float((lse - attention_lse(q, k, win)).abs().max()) <= lse_tol
    for a, b in zip(got, want):
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol * float(b.float().abs().max()), err


def test_split_bf16_sums_back_exactly():
    """The bfloat16 projections' backward cuts the float32 cotangent into
    three bfloat16 terms (``split_bf16``): their float32 sum is the
    cotangent, bitwise, over every exponent from 2**-108 up and both
    signs; a zero sums back to +0.0 (a product with either zero is a
    zero)."""
    gen = torch.Generator().manual_seed(0)
    n = 1 << 18
    mant = torch.rand(n, generator=gen) + 1
    expo = torch.randint(-108, 127, (n,), generator=gen).float()
    sign = torch.where(torch.rand(n, generator=gen) < 0.5, -1.0, 1.0)
    x = torch.cat([sign * mant * torch.exp2(expo),
                   torch.tensor([0.0, -0.0, 1.0, -3.0e38])])
    hi, mid, lo = split_bf16(x)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    back = (hi.float() + mid.float()) + lo.float()
    assert torch.equal(back[:-4].view(torch.int32), x[:-4].view(torch.int32))
    assert back[-4:].tolist() == x[-4:].tolist()  # -0.0 == 0.0


@pytest.mark.cuda
def test_cuda_bf16_projection_gradient_matches_float32():
    """A bfloat16 projection that needs a gradient (``matmul_f32``'s
    autograd function: ``torch.mm(..., out_dtype=float32)`` has none)
    against autograd of the float32 product of the same values: each
    gradient within 1e-2 relative L2 of it and within 1e-3 of it rounded
    to bfloat16.  The backward keeps the float32 cotangent and rounds
    only each gradient, as the reference's transpose; rounding the
    cotangent to bfloat16 first reads 2.4e-3 from the rounded gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    a = torch.randn(4, 256, 2048, generator=gen, device=dev).bfloat16()
    w = (torch.randn(2048, 8192, generator=gen, device=dev) / 45).bfloat16()
    dy = torch.randn(4, 256, 8192, generator=gen, device=dev)
    a.requires_grad_(True)
    w.requires_grad_(True)
    y = matmul_f32(a, w)
    assert y.dtype == torch.float32
    ga, gw = torch.autograd.grad(y, (a, w), dy)
    assert ga.dtype == torch.bfloat16 and gw.dtype == torch.bfloat16
    a32, w32 = (x.detach().float().requires_grad_(True) for x in (a, w))
    wa, ww = torch.autograd.grad(a32 @ w32, (a32, w32), dy)
    for got, want in ((ga, wa), (gw, ww)):
        rel = float((got.float() - want).norm() / want.norm())
        assert rel < 1e-2, rel
        want16 = want.bfloat16().float()
        rel16 = float((got.float() - want16).norm() / want16.norm())
        assert rel16 < 1e-3, rel16


@pytest.mark.cuda
def test_cuda_bf16_training_gradients_near_float32():
    """granite-3-2b ``.reduced()`` cut to 3 layers at a fan-in init
    (``tools/bf16_grad_readings.py``): the card's bfloat16 gradient (the
    flash kernels and the bfloat16 projections' autograd function) has
    every leaf within 0.05 relative L2 of the port's float32 gradient on
    the CPU at the same weights, and of the port's bfloat16 gradient on
    the CPU, which ``tests/test_torch_train_loss.py`` holds to the JAX
    package's (both packages read 0.006-0.018 from float32 there)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.data.pipeline import make_source
    from repro_torch.parallel.sharding import tree_map
    from tools.bf16_grad_readings import (distances, draw_params,
                                          model_config, rel_l2)
    dev = torch.device("cuda", 0)
    cfg16 = model_config("reduced", 3, "bfloat16")
    params = draw_params(cfg16, 0, "fan_in", "cpu")
    tokens = torch.from_numpy(make_source(
        "markov", cfg16.vocab_size, 64, 2, 0).batch_at(0))
    _, _, _, c16, c32 = distances(params, cfg16, tokens)
    launches = flash_attention_bwd.launches
    card = tree_map(lambda a: a.detach().to(dev), params)
    _, _, dist, g16, _ = distances(card, cfg16, tokens.to(dev))
    assert flash_attention_bwd.launches - launches == cfg16.num_layers
    for (name, x), a, b, c in zip(dist.items(), g16, c32, c16):
        assert x <= 0.05, (name, x)
        assert rel_l2(a.float().cpu(), b) <= 0.05, name
        assert rel_l2(a.float().cpu(), c.float()) <= 0.05, name
