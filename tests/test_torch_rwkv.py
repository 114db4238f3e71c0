"""The port's RWKV6 model (``repro_torch.models.rwkv`` and the ssm family
of ``repro_torch.models.transformer``) against the JAX package's, on
rwkv6-1.6b ``.reduced()`` (4 layers, d = 128, heads of 32, vocab 512,
float32).

At the reference's init the decay is constant (``w0`` and ``w_lora_b``
are zeros, so w_log = -1) and ``u``, ``mu`` and ``mu_c`` are zeros, which
would leave the data-dependent decay, the bonus and the token shift
unexercised.  So every case runs on the JAX package's init with those
five leaves drawn from a numpy seed (``w0`` uniform in [-3, 1.5],
``w_lora_b`` 0.1 N(0, 1), ``u`` 0.5 N(0, 1), ``mu`` and ``mu_c`` uniform
in [0, 1]), carried across with ``params_from_numpy`` /
``cache_from_numpy``.  The port's WKV6 wrapper runs its plain version here
(CPU tensors), the reference its chunked jnp form, both at chunk 16.

Tolerances: every compared tensor within TOL = 1e-5 of its largest
magnitude (plus TOL relative).  The reference's init draws the block
matrices with std 1/sqrt(L) = 0.5 (ROADMAP §3), so r, k and v reach about
10 and the WKV state about 5 x 10^2, where an absolute bound would mean a few float32
ulps; the two packages sum in float32 in different orders (measured: at
most 2.4e-6 of the largest magnitude, on the last hidden state).  Greedy
tokens agree wherever the reference's top-2 logit gap exceeds 1e-3.
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
from repro.models import rwkv as JR
from repro.models import transformer as J
from repro.parallel.sharding import ParamSpec as JParamSpec
from repro_torch.configs import get_config
from repro_torch.kernels.rwkv6 import wkv6_kernel
from repro_torch.models import rwkv as TR
from repro_torch.models import transformer as T
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ARCH = "rwkv6-1.6b"
B, P, STEPS = 2, 32, 3
TOL = 1e-5


def perturb(params, seed):
    """The five decay and mix leaves of every layer drawn from ``seed``
    (numpy float32 arrays in place of the reference's zeros)."""
    rng = np.random.default_rng(seed)
    blocks = dict(params["blocks"])
    draws = {"w0": lambda s: rng.uniform(-3.0, 1.5, s),
             "w_lora_b": lambda s: 0.1 * rng.normal(size=s),
             "u": lambda s: 0.5 * rng.normal(size=s),
             "mu": lambda s: rng.uniform(0.0, 1.0, s),
             "mu_c": lambda s: rng.uniform(0.0, 1.0, s)}
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
    assert tc.attn_k is None and tc.attn_v is None and tc.mamba is None
    for i, name in enumerate(("last_tm", "last_cm", "wkv")):
        close(tc.rwkv[i], jc.rwkv[i], f"{what}: {name}")


@pytest.fixture(scope="module")
def run():
    """One JAX serving run: forward, prefill, then STEPS serve_steps (each
    with its logits), all on the same perturbed weights."""
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
    last, cache = jax.jit(lambda p, c, t: J.prefill(
        p, jcfg, c, {"tokens": t}))(jp, cache0, toks[:, :P])

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
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, toks=toks,
                x_par=np.asarray(x_par), cache0=np_tree(cache0),
                last=np.asarray(last), cache=np_tree(cache), steps=steps)


def test_rwkv_block_matches_the_reference(run):
    """Layer 0 on a random input from a random non-zero state, prefill
    (S = P) and decode (S = 1)."""
    cfg = run["tcfg"]
    d, K = cfg.d_model, cfg.rwkv_head_dim
    p0 = {k: v[0] for k, v in run["params"]["blocks"].items()}
    rng = np.random.default_rng(6)
    for S in (P, 1):
        x = rng.normal(size=(B, S, d)).astype(np.float32)
        state = (rng.normal(size=(B, d)).astype(np.float32),
                 rng.normal(size=(B, d)).astype(np.float32),
                 rng.normal(size=(B, d // K, K, K)).astype(np.float32))
        jx, jst = JR.rwkv_block(jax.tree.map(jnp.asarray, p0),
                                jnp.asarray(x),
                                tuple(map(jnp.asarray, state)), K,
                                cfg.norm_eps, False)
        tx, tst = TR.rwkv_block(T.params_from_numpy(p0, "cpu"),
                                torch.from_numpy(x),
                                tuple(map(torch.from_numpy, state)), K,
                                cfg.norm_eps, True)
        close(tx, jx, f"S={S}: x")
        for i, name in enumerate(("last_tm", "last_cm", "wkv")):
            close(tst[i], jst[i], f"S={S}: {name}")
    assert wkv6_kernel.launches == 0


def test_forward_matches_the_reference(run):
    tp = T.params_from_numpy(run["params"], "cpu")
    x, cache, aux = T.forward(tp, run["tcfg"],
                              {"tokens": torch.tensor(run["toks"][:, :P])})
    assert cache is None and int(aux["overflow"]) == 0
    close(x, run["x_par"], "forward")


def test_prefill_and_serve_steps_match_the_reference(run):
    tcfg = run["tcfg"]
    tp = T.params_from_numpy(run["params"], "cpu")
    cache = T.cache_from_numpy(run["cache0"], "cpu")
    assert isinstance(cache.rwkv, tuple)
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
    assert wkv6_kernel.launches == 0


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
    # the reference's init: the decay and mix leaves start at zero, so
    # w_log = -exp(0) = -1 everywhere and the bonus is 0
    p = T.init_params(torch.Generator().manual_seed(1), tcfg, "cpu")
    for name in ("w0", "w_lora_b", "u", "mu", "mu_c"):
        assert not p["blocks"][name].any(), name
    L = tcfg.num_layers
    assert abs(float(p["blocks"]["w_r"].std()) - L ** -0.5) < 0.01


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
    assert int(cache.pos) == h
    for t in range(h, h + STEPS):
        x1, cache, _ = T.forward(tp, tcfg, {"tokens": toks[:, t:t + 1]},
                                 cache=cache)
        close(x1[:, 0], x_par[:, t].numpy(), f"step {t}", 5e-3)
    assert int(cache.pos) == h + STEPS
    cache = T.init_cache(tcfg, B, P, "cpu")
    for t in range(8):
        x1, cache, _ = T.forward(tp, tcfg, {"tokens": toks[:, t:t + 1]},
                                 cache=cache)
        close(x1[:, 0], x_par[:, t].numpy(), f"from empty, step {t}", 5e-3)


def test_full_config_matches_the_reference():
    """The full rwkv6-1.6b config (not materialized): every field, and
    the parameter count."""
    j, t = j_get_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert t.param_count() == j.param_count() == 1_828_716_544
    assert (t.num_layers, t.d_model, t.rwkv_head_dim, t.d_ff,
            t.vocab_size) == (24, 2048, 64, 7168, 65536)


def test_serve_launcher_runs_rwkv6_on_cpu():
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
