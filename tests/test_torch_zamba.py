"""The port's zamba2 hybrid (``repro_torch.models.mamba`` and the hybrid
family of ``repro_torch.models.transformer``) against the JAX package's,
on zamba2-2.7b ``.reduced()`` (12 layers = 2 superblocks of the shared
attention block and 6 Mamba2 layers, d = 128, 4 heads of 32, window 64,
Mamba2 heads P = 32 with state N = 16, vocab 512, float32).

At the reference's init ``a_log``, ``dt_bias`` and ``conv_b`` are zeros
and ``d_skip`` ones in every head, so a port that read one head's decay
for every head would pass.  So every case runs on the JAX package's init
with those four leaves drawn from a numpy seed (``a_log`` uniform in
[-6, 1], ``dt_bias`` uniform in [-4, 4], ``d_skip`` and ``conv_b``
N(0, 1)), carried across with ``params_from_numpy`` /
``cache_from_numpy``.  The port's kernel wrappers run their plain
versions here (CPU tensors), the reference its jnp forms, the SSD at
chunk 16.

Tolerances: every compared tensor within a bound of its largest magnitude
(plus the same bound relative): BLOCK_TOL = 1e-5 for one Mamba2 block,
TOL = 1e-4 for the model's hidden states and cache fields.  The
reference's init draws the nested stacked Mamba2 leaves with std
1/sqrt(L // k) = 0.71 (ROADMAP §3), so the in_proj outputs reach about 10
and the SSD state about 10^2, where an absolute bound would mean a few
float32 ulps.  The two packages sum every product in float32 in different
orders, and the differences grow through the layers (measured: at most
5.5e-7 for one block, 7.0e-6 after one superblock and 2.2e-5 after two,
on the scoring forward; the JAX package's own two SSD forms, chunked jnp
and Pallas, put that forward 7.1e-6 apart).  Greedy tokens agree wherever
the reference's top-2 logit gap exceeds 1e-3.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import mamba as JM
from repro.models import transformer as J
from repro.parallel.sharding import ParamSpec as JParamSpec
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.mamba2 import ssd_kernel
from repro_torch.models import mamba as TM
from repro_torch.models import transformer as T
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ARCH = "zamba2-2.7b"
B, P, STEPS, P2 = 2, 32, 3, 16
BLOCK_TOL = 1e-5
TOL = 1e-4


def perturb(params, seed):
    """The four Mamba2 leaves the reference's init leaves constant, drawn
    from ``seed`` (numpy float32 arrays in place of zeros and ones)."""
    rng = np.random.default_rng(seed)
    blocks = dict(params["blocks"])
    draws = {"a_log": lambda s: rng.uniform(-6.0, 1.0, s),
             "dt_bias": lambda s: rng.uniform(-4.0, 4.0, s),
             "d_skip": lambda s: rng.normal(size=s),
             "conv_b": lambda s: rng.normal(size=s)}
    for name, fn in draws.items():
        blocks[name] = fn(blocks[name].shape).astype(np.float32)
    return {**params, "blocks": blocks}


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def leaves(tree, path=""):
    """{path: leaf} of nested dicts / tuples; None subtrees are skipped."""
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in leaves(tree[key], f"{path}/{key}").items()}
    if isinstance(tree, tuple) and not isinstance(tree, JParamSpec):
        return {k: v for i, x in enumerate(tree) if x is not None
                for k, v in leaves(x, f"{path}/{i}").items()}
    return {path: tree}


def close(got, want, what, tol=TOL):
    want = np.asarray(want)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max(), err_msg=what)


def assert_cache(tc, jc, what):
    assert int(tc.pos) == int(jc.pos), what
    assert tc.rwkv is None and jc.rwkv is None
    close(tc.attn_k, jc.attn_k, f"{what}: attn_k")
    close(tc.attn_v, jc.attn_v, f"{what}: attn_v")
    for i, name in enumerate(("conv", "ssd")):
        close(tc.mamba[i], jc.mamba[i], f"{what}: {name}")


@pytest.fixture(scope="module")
def run():
    """One JAX serving run on the perturbed weights: forward, prefill,
    STEPS serve_steps (each with its logits), then a second prefill of P2
    tokens on the filled cache, and a one-token prefill on an empty
    cache."""
    jcfg = j_get_config(ARCH).reduced()
    tcfg = get_config(ARCH).reduced()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    params = perturb(np_tree(J.init_params(jax.random.PRNGKey(3), jcfg)),
                     seed=5)
    jp = jax.tree.map(jnp.asarray, params)
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(4),
                                         (B, P + STEPS), 0,
                                         jcfg.vocab_size, jnp.int32))
    x_par, _, _ = jax.jit(lambda p, t: J.forward(
        p, jcfg, {"tokens": t}, remat=False))(jp, toks[:, :P])
    cache0 = J.init_cache(jcfg, B, P + STEPS)
    prefill = jax.jit(lambda p, c, t: J.prefill(p, jcfg, c, {"tokens": t}))
    last, cache = prefill(jp, cache0, toks[:, :P])

    @jax.jit
    def step(p, c, t):
        nxt, c2 = J.serve_step(p, jcfg, c, t)
        x, _, _ = J.forward(p, jcfg, {"tokens": t}, cache=c, remat=False)
        return nxt, c2, jnp.einsum("bd,dv->bv", x[:, -1], p["lm_head"])

    steps = []
    c = cache
    for s in range(STEPS):
        tok = toks[:, P + s:P + s + 1]
        nxt, c, logits = step(jp, c, tok)
        steps.append((tok, np.asarray(nxt), np_tree(c), np.asarray(logits)))
    again = prefill(jp, c, toks[:, 3:3 + P2])
    one = prefill(jp, cache0, toks[:, :1])
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, toks=toks,
                x_par=np.asarray(x_par), cache0=np_tree(cache0),
                last=np.asarray(last), cache=np_tree(cache), steps=steps,
                again=(np.asarray(again[0]), np_tree(again[1])),
                one=(np.asarray(one[0]), np_tree(one[1])))


def test_mamba_block_matches_the_reference(run):
    """Layer (0, 0) on a random input: prefill (S = P) from no state and
    from a random non-zero state, and decode (S = 1)."""
    cfg = run["tcfg"]
    d, N, hp = cfg.d_model, cfg.ssm_state, cfg.ssm_head_dim
    din = cfg.ssm_expand * d
    p0 = {k: v[0, 0] for k, v in run["params"]["blocks"].items()}
    jp0 = jax.tree.map(jnp.asarray, p0)
    tp0 = T.params_from_numpy(p0, "cpu")
    rng = np.random.default_rng(6)
    for S, with_state in ((P, False), (P, True), (1, True)):
        x = rng.normal(size=(B, S, d)).astype(np.float32)
        state = None
        if with_state:
            state = (rng.normal(size=(B, TM.CONV_K - 1, din + 2 * N)),
                     rng.normal(size=(B, din // hp, hp, N)))
            state = tuple(a.astype(np.float32) for a in state)
        jx, jst = JM.mamba_block(
            jp0, jnp.asarray(x),
            None if state is None else tuple(map(jnp.asarray, state)),
            run["jcfg"], False)
        tx, tst = TM.mamba_block(
            tp0, torch.from_numpy(x),
            None if state is None else tuple(map(torch.from_numpy, state)),
            cfg, True)
        what = f"S={S}, state {'drawn' if with_state else 'none'}"
        close(tx, jx, f"{what}: x", BLOCK_TOL)
        close(tst[0], jst[0], f"{what}: conv", BLOCK_TOL)
        close(tst[1], jst[1], f"{what}: ssd", BLOCK_TOL)
    assert ssd_kernel.launches == 0


def test_forward_matches_the_reference(run):
    tp = T.params_from_numpy(run["params"], "cpu")
    x, cache, aux = T.forward(tp, run["tcfg"],
                              {"tokens": torch.tensor(run["toks"][:, :P])})
    assert cache is None and int(aux["overflow"]) == 0
    close(x, run["x_par"], "forward")


def test_prefill_and_serve_steps_match_the_reference(run):
    """Prefill, STEPS greedy steps (cache fields, hidden, tokens), then a
    second prefill on the filled cache: its attention writes positions
    0..P2-1, its conv restarts from zero padding and its SSD continues
    from the cache's state, as the reference's does."""
    tcfg = run["tcfg"]
    tp = T.params_from_numpy(run["params"], "cpu")
    cache = T.cache_from_numpy(run["cache0"], "cpu")
    assert isinstance(cache.mamba, tuple) and cache.rwkv is None
    last, cache = T.prefill(tp, tcfg, cache,
                            {"tokens": torch.tensor(run["toks"][:, :P])})
    close(last, run["last"], "prefill: last hidden")
    assert_cache(cache, run["cache"], "prefill")
    compared = 0
    for s, (tok, j_nxt, j_cache, logits) in enumerate(run["steps"]):
        nxt, cache = T.serve_step(tp, tcfg, cache, torch.tensor(tok))
        assert nxt.dtype == torch.int32 and nxt.shape == (B,)
        top2 = np.sort(logits, axis=-1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > 1e-3
        np.testing.assert_array_equal(nxt.numpy()[sure], j_nxt[sure])
        compared += int(sure.sum())
        assert_cache(cache, j_cache, f"step {s}")
    assert compared >= B * STEPS - 1
    last, cache = T.prefill(tp, tcfg, cache, {"tokens": torch.tensor(
        run["toks"][:, 3:3 + P2])})
    close(last, run["again"][0], "second prefill: last hidden")
    assert_cache(cache, run["again"][1], "second prefill")
    assert ssd_kernel.launches == flash_attention.launches == 0


def test_one_token_prefill_takes_the_decode_path(run):
    """A one-token prompt is a decode step, on the reference as on the
    port: the conv steps from the cache's carry and the attention writes
    the ring slot of position 0."""
    tp = T.params_from_numpy(run["params"], "cpu")
    cache = T.cache_from_numpy(run["cache0"], "cpu")
    last, cache = T.prefill(tp, run["tcfg"], cache, {"tokens": torch.tensor(
        run["toks"][:, :1])})
    close(last, run["one"][0], "one-token prefill: last hidden")
    assert_cache(cache, run["one"][1], "one-token prefill")


def test_prompt_lengths_are_refused_where_the_reference_asserts(run):
    """200 tokens (> 16, not a multiple of 16) are refused by the SSD, as
    the reference's ``ssd_chunked`` asserts; 528 (a multiple of 16, not of
    512) by the attention, as ``blockwise_attention`` asserts.  The port
    raises ValueError on both paths; 208 tokens are served."""
    tcfg, jcfg = run["tcfg"], run["jcfg"]
    tp = T.params_from_numpy(run["params"], "cpu")
    rng = np.random.default_rng(8)
    for S, where in ((200, "multiple of the chunk"),
                     (528, "multiple of the blocks")):
        toks = rng.integers(0, tcfg.vocab_size, (1, S)).astype(np.int32)
        with pytest.raises(AssertionError):
            J.prefill(jax.tree.map(jnp.asarray, run["params"]), jcfg,
                      J.init_cache(jcfg, 1, S), {"tokens": toks})
        for use in (True, False):
            with pytest.raises(ValueError, match=where):
                T.prefill(tp, tcfg, T.init_cache(tcfg, 1, S, "cpu"),
                          {"tokens": torch.from_numpy(toks)},
                          use_kernels=use)
    toks = torch.from_numpy(
        rng.integers(0, tcfg.vocab_size, (1, 208)).astype(np.int32))
    last, cache = T.prefill(tp, tcfg, T.init_cache(tcfg, 1, 208, "cpu"),
                            {"tokens": toks})
    x, _, _ = T.forward(tp, tcfg, {"tokens": toks})
    close(last, x[:, -1].numpy(), "208 tokens: prefill vs forward", 1e-6)
    assert int(cache.pos) == 208


def test_init_shapes_and_dtypes_match_the_reference(run):
    tcfg, jcfg = run["tcfg"], run["jcfg"]
    gen = torch.Generator().manual_seed(0)
    for got, spec in (
            (T.init_params(gen, tcfg, "cpu"), J.abstract_params(jcfg)),
            (T.init_cache(tcfg, B, P + STEPS, "cpu"),
             J.abstract_cache(jcfg, B, P + STEPS))):
        got, want = leaves(got), leaves(spec)
        assert sorted(got) == sorted(want)
        for k, s in want.items():
            assert tuple(got[k].shape) == s.shape, k
            assert got[k].dtype == getattr(torch, s.dtype), k
    # the reference's init: constant decays, biases and skips, and the
    # nested stacked leaves drawn with fan_in = L // k
    p = T.init_params(torch.Generator().manual_seed(1), tcfg, "cpu")
    blocks = p["blocks"]
    for name in ("a_log", "dt_bias", "conv_b"):
        assert not blocks[name].any(), name
    assert bool((blocks["d_skip"] == 1).all())
    n_sb = tcfg.num_layers // tcfg.attn_every
    assert blocks["in_proj"].shape[:2] == (n_sb, tcfg.attn_every)
    assert abs(float(blocks["in_proj"].std()) - n_sb ** -0.5) < 0.01


def test_prefill_then_decode_matches_parallel_forward(run):
    """prefill(first half) + decode steps == one parallel forward of the
    prompt, and decode from an empty cache step by step == the same
    forward, on the port alone (as tests/test_arch_smoke.py:121 holds the
    reference)."""
    tcfg = run["tcfg"]
    tp = T.params_from_numpy(run["params"], "cpu")
    toks = torch.tensor(run["toks"][:, :P])
    x_par, _, _ = T.forward(tp, tcfg, {"tokens": toks})
    h = P // 2
    cache = T.init_cache(tcfg, B, P, "cpu")
    last, cache = T.prefill(tp, tcfg, cache, {"tokens": toks[:, :h]})
    close(last, x_par[:, h - 1].numpy(), "prefill", 5e-3)
    for t in range(h, h + STEPS):
        x1, cache, _ = T.forward(tp, tcfg, {"tokens": toks[:, t:t + 1]},
                                 cache=cache)
        close(x1[:, 0], x_par[:, t].numpy(), f"step {t}", 5e-3)
    assert int(cache.pos) == h + STEPS
    cache = T.init_cache(tcfg, B, P, "cpu")
    for t in range(4):
        x1, cache, _ = T.forward(tp, tcfg, {"tokens": toks[:, t:t + 1]},
                                 cache=cache)
        close(x1[:, 0], x_par[:, t].numpy(), f"from empty, step {t}", 5e-3)


def test_full_config_matches_the_reference():
    """The full zamba2-2.7b config (not materialized): every field, the
    analytic parameter count, and every parameter and cache leaf's shape
    and dtype."""
    j, t = j_get_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert t.param_count() == j.param_count()
    assert (t.num_layers, t.d_model, t.num_heads, t.num_kv_heads, t.hd,
            t.attn_every, t.ssm_state, t.ssm_head_dim, t.sliding_window) \
        == (54, 2560, 32, 32, 80, 6, 64, 64, 4096)
    for got, want in ((T.abstract_params(t), J.abstract_params(j)),
                      (T.abstract_cache(t, 4, 2064),
                       J.abstract_cache(j, 4, 2064))):
        got, want = leaves(got), leaves(want)
        assert sorted(got) == sorted(want)
        for k, s in want.items():
            assert (got[k].shape, got[k].dtype) == (s.shape, s.dtype), k
    made = sum(int(np.prod(s.shape)) for s in
               leaves(T.abstract_params(t)).values())
    assert made == 2_422_670_240


def test_serve_launcher_runs_zamba2_on_cpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--device", "cpu", "--batch", "2", "--prompt-len", "32",
         "--gen", "3"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "prefill 2x32" in out.stdout and "decode 2x3" in out.stdout
    assert "on cpu" in out.stdout
