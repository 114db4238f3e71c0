"""The port's training loss and its gradients (``repro_torch.models.
transformer`` ``chunked_xent`` / ``lm_loss``, the flash attention's
autograd function) against the JAX package's on the same inputs, in
float32 on the CPU, where the attention runs its plain versions.

Tolerances: ``chunked_xent`` rtol 1e-5, the reference's own against its
naive oracle (``tests/test_loss_and_limits.py:38``); the attention's
gradients 1e-5 of each gradient's largest magnitude (float32 sums in
other orders); the reduced model's loss rtol 1e-5 and every gradient leaf
within a relative L2 distance of 1e-3 from the reference's (the backward
crosses 4 layers under the reference's init, std 1/sqrt(L) on every block
matrix, whose large Jacobians grow the float32 summation-order
differences: the embedding's gradient is ~1.5e-4 off on the CPU); in
bfloat16, at a fan-in init, every gradient leaf within BF16_GRAD_REL of
the float32 gradient and of the reference's bfloat16 gradient.
The backward kernel's wrapper and the kernel itself are tested in
``tests/test_torch_flash_bwd_kernel.py``, which imports no JAX.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import transformer as J
from repro.models.layers import blockwise_attention as j_blockwise
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import (FlashAttention, attention,
                                                 attention_lse,
                                                 flash_attention_fwd,
                                                 repeat_kv_attention)
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import leaves
from repro_torch.runtime.trainer import TrainConfig, make_train_step, train
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

# a bfloat16 gradient leaf's relative L2 distance from the float32 one at a
# fan-in init: about 3x the largest that either package reads (0.018)
BF16_GRAD_REL = 0.05


# --------------------------------------------------------------------------
# chunked_xent and lm_loss
# --------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,d,V,chunk", [(2, 64, 16, 50, 16),
                                           (1, 33, 8, 20, 16),  # ragged
                                           (3, 128, 32, 100, 512)])
def test_chunked_xent_matches_jax(B, S, d, V, chunk):
    """``tests/test_loss_and_limits.py:28``'s cases: the port's
    chunked_xent against the JAX package's on the same numpy inputs."""
    rng = np.random.default_rng(B * S)
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    w = (rng.normal(size=(d, V)) * 0.1).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = np.broadcast_to((np.arange(S) < S - 3).astype(np.float32),
                           (B, S)).copy()
    want = float(J.chunked_xent(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(labels), jnp.asarray(mask),
                                chunk=chunk))
    got = float(T.chunked_xent(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(labels),
                               torch.from_numpy(mask), chunk=chunk))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def two_layer_cfgs():
    j = dataclasses.replace(j_get_config("granite-3-2b").reduced(),
                            num_layers=2)
    t = dataclasses.replace(get_config("granite-3-2b").reduced(),
                            num_layers=2)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def test_lm_loss_with_negative_labels_matches_jax():
    """Labels below 0 are masked out of the loss in both packages (and
    still embedded as tokens: both wrap a negative id), on the case of
    ``tests/test_loss_and_limits.py:63``."""
    jcfg, tcfg = two_layer_cfgs()
    params = jax.tree.map(np.asarray,
                          J.init_params(jax.random.PRNGKey(0), jcfg))
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (1, 16)).astype(np.int32)
    masked = toks.copy()
    masked[:, 8:] = -1
    tp = T.params_from_numpy(params, "cpu")
    for t in (toks, masked):
        want, _ = J.lm_loss(params, jcfg, {"tokens": jnp.asarray(t)},
                            remat=False)
        got, metrics = T.lm_loss(tp, tcfg, {"tokens": torch.from_numpy(t)},
                                 remat=False)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        assert float(metrics["xent"]) == float(got)
    got_full, _ = T.lm_loss(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    got_masked, _ = T.lm_loss(tp, tcfg,
                              {"tokens": torch.from_numpy(masked)})
    assert abs(float(got_masked) - float(got_full)) > 1e-6


def test_reduced_model_loss_and_every_gradient_leaf_match_jax():
    """granite-3-2b ``.reduced()`` (4 layers, d 128, 4 heads of 32): the
    loss and the gradient of every leaf, the port's remat path (flash
    attention's autograd function, its plain versions on the CPU) against
    ``jax.value_and_grad`` of the reference's ``lm_loss``."""
    jcfg = j_get_config("granite-3-2b").reduced()
    tcfg = get_config("granite-3-2b").reduced()
    pj = J.init_params(jax.random.PRNGKey(0), jcfg)
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    toks[1, 10:] = -1
    (want, _), gj = jax.value_and_grad(
        lambda p: J.lm_loss(p, jcfg, {"tokens": jnp.asarray(toks)}),
        has_aux=True)(pj)
    tp = T.params_from_numpy(jax.tree.map(np.asarray, pj), "cpu")
    flat = leaves(tp)
    for p in flat:
        p.requires_grad_(True)
    got, _ = T.lm_loss(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(got, flat)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    want_leaves = jax.tree.leaves(jax.tree.map(np.asarray, gj))
    assert len(want_leaves) == len(grads)
    for a, b in zip(want_leaves, grads):
        b = b.numpy()
        assert a.shape == b.shape
        rel = np.linalg.norm(a - b) / np.linalg.norm(a)
        assert rel < 1e-3, (a.shape, rel)


def test_bf16_gradients_match_jax_at_a_fan_in_init():
    """granite-3-2b ``.reduced()`` cut to 3 layers, the reference's draws
    scaled to a fan-in init (``tools/bf16_grad_readings.py``), bfloat16
    weights: every bfloat16 gradient leaf, the port's and the JAX
    package's, within BF16_GRAD_REL of the float32 gradient at the same
    weights (both read 0.006-0.018), the port's within BF16_GRAD_REL of
    the reference's bfloat16 gradient, and the float32 gradients within
    1e-4 (read: 1.7e-6).  At the reference's own init both packages'
    bfloat16 gradients are 0.67-1.18 from their float32 ones on the block
    leaves (ROADMAP §3), so that init is read, not held."""
    from tools.bf16_grad_readings import (distances, draw_params,
                                          model_config, reference_readings)
    from repro_torch.data.pipeline import make_source
    cfg16 = model_config("reduced", 3, "bfloat16")
    params = draw_params(cfg16, 0, "fan_in", "cpu")
    tokens = torch.from_numpy(make_source(
        "markov", cfg16.vocab_size, 64, 2, 0).batch_at(0))
    _, _, dist, g16, g32 = distances(params, cfg16, tokens)
    ref = reference_readings(params, cfg16, tokens, g16, g32)
    for name, x in dist.items():
        assert x <= BF16_GRAD_REL, (name, x)
        assert ref["bf16_from_f32"][name] <= BF16_GRAD_REL, name
        assert ref["port_bf16_from_ref_bf16"][name] <= BF16_GRAD_REL, name
        assert ref["port_f32_from_ref_f32"][name] <= 1e-4, name


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-2.7b"])
def test_training_refuses_the_families_without_backward_kernels(arch):
    cfg = get_config(arch).reduced()
    toks = torch.zeros((1, 16), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="rwkv6 and zamba2 "
                                                  "training"):
        T.lm_loss({}, cfg, {"tokens": toks})
    with pytest.raises(NotImplementedError, match="rwkv6 and zamba2 "
                                                  "training"):
        make_train_step(cfg, TrainConfig())
    with pytest.raises(NotImplementedError, match="rwkv6 and zamba2 "
                                                  "training"):
        train(cfg, TrainConfig(), device="cpu")
    with pytest.raises(NotImplementedError, match="rwkv6 and zamba2 "
                                                  "training"):
        T.forward({}, cfg, {"tokens": toks}, remat=True)


def test_remat_refuses_a_cache():
    """remat recomputes a scoring pass; a prefill into a cache keeps no
    backward, so it is refused rather than ignored."""
    with pytest.raises(ValueError, match="no cache"):
        T.forward({}, get_config("granite-3-2b").reduced(),
                  {"tokens": torch.zeros((1, 16), dtype=torch.int32)},
                  cache=object(), remat=True)


def test_train_refuses_a_mesh():
    with pytest.raises(NotImplementedError, match="training on a mesh"):
        train(get_config("granite-3-2b").reduced(), TrainConfig(),
              mesh=object(), device="cpu")


# --------------------------------------------------------------------------
# The attention's gradient
# --------------------------------------------------------------------------

ATTN_CASES = {"G1": (2, 32, 4, 4, 32, 0), "G2": (2, 32, 4, 2, 32, 0),
              "window4": (1, 32, 4, 2, 32, 4)}


def attn_inputs(B, S, H, Hkv, hd):
    rng = np.random.default_rng(S * H + Hkv)
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, hd)).astype(np.float32)
    do = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    return q, k, v, do


def close_to_max(got, want, tol=1e-5):
    got = np.asarray(got)
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), \
        np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_gradient_matches_jax_grad(case):
    """dq, dk, dv of the attention at a cotangent dO: the port's autograd
    function (forward plain + logsumexp, backward plain) and autograd
    through ``attention(use_kernel=False)`` against ``jax.vjp`` of the
    reference's ``blockwise_attention`` over K/V repeated to H heads."""
    B, S, H, Hkv, hd, win = ATTN_CASES[case]
    q, k, v, do = attn_inputs(B, S, H, Hkv, hd)
    G = H // Hkv
    pos = jnp.arange(S, dtype=jnp.int32)

    def ref(q, k, v):
        return j_blockwise(q, jnp.repeat(k, G, axis=2),
                           jnp.repeat(v, G, axis=2), pos, window=win)
    out, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]

    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    got_out = FlashAttention.apply(tq, tk, tv, win)
    close_to_max(got_out.detach(), np.asarray(out))
    for a, b in zip(torch.autograd.grad(got_out, (tq, tk, tv),
                                        torch.from_numpy(do)), want):
        close_to_max(a, b)
    tpos = torch.arange(S, dtype=torch.int32)
    plain = attention(tq, tk, tv, tpos, window=win, use_kernel=False)
    for a, b in zip(torch.autograd.grad(plain, (tq, tk, tv),
                                        torch.from_numpy(do)), want):
        close_to_max(a, b)


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_forward_logsumexp_is_each_rows_softmax_normalizer(case):
    """The training forward's second output: exp(scale s - lse) sums to 1
    over each row's live keys, and the output is the plain version's."""
    B, S, H, Hkv, hd, win = ATTN_CASES[case]
    q, k, v, _ = (torch.from_numpy(x) for x in attn_inputs(B, S, H, Hkv,
                                                             hd))
    out, lse = flash_attention_fwd(q, k, v, win)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    pos = torch.arange(S, dtype=torch.int32)
    assert torch.equal(out, repeat_kv_attention(q, k, v, pos, win))
    G = H // Hkv
    kf = k.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kf) * hd ** -0.5
    i, j = torch.arange(S)[:, None], torch.arange(S)[None, :]
    live = (j <= i) & ((j > i - win) if win else True)
    p = torch.where(live, torch.exp(s - lse[..., None]), 0.0)
    torch.testing.assert_close(p.sum(-1), torch.ones(B, H, S), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(attention_lse(q, k, win), lse)
