"""The port's dense transformer (``repro_torch.models.transformer``)
against the JAX package's on granite-3-2b ``.reduced()`` (4 layers,
d = 128, 4 heads of 32, float32), as it is (G = 1), with two kv heads
(G = 2) and with a 4-token window (a ring cache of C = 4 < S slots).

The JAX package's params and caches are carried across with
``params_from_numpy`` / ``cache_from_numpy``, so both run on identical
weights.  Hidden states agree within rtol = atol = 1e-4; greedy tokens
wherever the reference's top-2 logit gap exceeds 1e-3.  The cached K/V
are not normalized: the reference's init (std 1/sqrt(L) = 0.5 on every
block matrix) makes them reach |20|, where 1e-4 is a few float32 ulps, so
they agree within rtol 1e-4 and an atol of 1e-4 times their largest
magnitude (the float32 sums of the two packages run in different
orders).  The port's attention runs its plain version here (CPU
tensors).
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
from repro.models import transformer as J
from repro.parallel.sharding import ParamSpec as JParamSpec
from repro_torch.configs import get_config, list_archs
from repro_torch.core.embedding import routed_embed
from repro_torch.models import transformer as T

pytestmark = pytest.mark.torch_port

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
B, P, STEPS = 2, 8, 3
TOL = 1e-4
VARIANTS = {"G1": {}, "G2": {"num_kv_heads": 2},
            "window4": {"sliding_window": 4}}


def cfgs(variant):
    j = dataclasses.replace(j_get_config("granite-3-2b").reduced(),
                            **VARIANTS[variant])
    t = dataclasses.replace(get_config("granite-3-2b").reduced(),
                            **VARIANTS[variant])
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=list(VARIANTS))
def run(request):
    """One JAX serving run per variant: forward, prefill, then STEPS
    serve_steps (each with its logits), all on the same weights."""
    jcfg, tcfg = cfgs(request.param)
    jp = J.init_params(jax.random.PRNGKey(3), jcfg)
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(4),
                                         (B, P + STEPS), 0,
                                         jcfg.vocab_size, jnp.int32))
    x_par, _, _ = jax.jit(lambda p, t: J.forward(
        p, jcfg, {"tokens": t}, remat=False))(jp, toks)
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
    return dict(jcfg=jcfg, tcfg=tcfg, params=np_tree(jp), toks=toks,
                x_par=np.asarray(x_par), cache0=np_tree(cache0),
                last=np.asarray(last), cache=np_tree(cache), steps=steps)


def leaves(tree, path=""):
    """{path: leaf} of nested dicts / tuples; None subtrees are skipped."""
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in leaves(tree[key], f"{path}/{key}").items()}
    if isinstance(tree, tuple) and not isinstance(tree, JParamSpec):
        return {k: v for i, x in enumerate(tree) if x is not None
                for k, v in leaves(x, f"{path}/{i}").items()}
    return {path: tree}


def assert_cache(tc, jc, what):
    assert int(tc.pos) == int(jc.pos), what
    for name in ("attn_k", "attn_v"):
        want = getattr(jc, name)
        np.testing.assert_allclose(getattr(tc, name).numpy(), want,
                                   rtol=TOL, atol=TOL * np.abs(want).max(),
                                   err_msg=f"{what}: {name}")


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
    # the reference's init rule: fan_in = shape[0], the layer count for a
    # stacked block leaf
    p = T.init_params(torch.Generator().manual_seed(1), tcfg, "cpu")
    L = tcfg.num_layers
    assert abs(float(p["blocks"]["mlp"]["w_up"].std()) - L ** -0.5) < 0.01
    assert abs(float(p["lm_head"].std()) - tcfg.d_model ** -0.5) < 0.01
    assert abs(float(p["embed"].std()) - 0.02) < 0.001


def test_forward_matches_the_reference(run):
    tp = T.params_from_numpy(run["params"], "cpu")
    x, cache, aux = T.forward(tp, run["tcfg"],
                              {"tokens": torch.tensor(run["toks"])})
    assert cache is None and int(aux["overflow"]) == 0
    np.testing.assert_allclose(x.numpy(), run["x_par"], rtol=TOL, atol=TOL)


def test_prefill_and_serve_steps_match_the_reference(run):
    tcfg = run["tcfg"]
    tp = T.params_from_numpy(run["params"], "cpu")
    cache = T.cache_from_numpy(run["cache0"], "cpu")
    last, cache = T.prefill(tp, tcfg, cache,
                            {"tokens": torch.tensor(run["toks"][:, :P])})
    np.testing.assert_allclose(last.numpy(), run["last"], rtol=TOL, atol=TOL)
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


def test_prefill_then_decode_matches_parallel_forward(run):
    """prefill(prompt) + decode steps == one parallel forward, on the
    port alone (as tests/test_arch_smoke.py:167 holds the reference)."""
    tcfg = run["tcfg"]
    gen = torch.Generator().manual_seed(12)
    tp = T.init_params(gen, tcfg, "cpu")
    toks = torch.tensor(run["toks"])
    x_par, _, _ = T.forward(tp, tcfg, {"tokens": toks})
    cache = T.init_cache(tcfg, B, P + STEPS, "cpu")
    last, cache = T.prefill(tp, tcfg, cache, {"tokens": toks[:, :P]})
    torch.testing.assert_close(last, x_par[:, P - 1], rtol=5e-3, atol=5e-3)
    assert int(cache.pos) == P
    for t in range(P, P + STEPS):
        x1, cache, _ = T.forward(tp, tcfg, {"tokens": toks[:, t:t + 1]},
                                 cache=cache)
        torch.testing.assert_close(x1[:, 0], x_par[:, t], rtol=5e-3,
                                   atol=5e-3)
    assert int(cache.pos) == P + STEPS


def test_what_is_not_ported_raises():
    assert list_archs() == ["granite-3-2b", "rwkv6-1.6b", "zamba2-2.7b"]
    with pytest.raises(KeyError, match="ROADMAP"):
        get_config("mixtral-8x22b")
    with pytest.raises(KeyError, match="unknown"):
        get_config("no-such-arch")
    assert get_config("rwkv6-1.6b").family == "ssm"   # ported
    assert get_config("zamba2-2.7b").family == "hybrid"   # ported
    for arch in ("rwkv6-1.6b", "zamba2-2.7b"):
        T.abstract_params(get_config(arch).reduced())
    cfg = get_config("granite-3-2b").reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.abstract_params(dataclasses.replace(cfg, family="moe"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.lm_loss(None, cfg, {})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.chunked_xent(None, None, None, None)
    with pytest.raises(NotImplementedError, match="SPMD on torch.distributed"):
        routed_embed(torch.zeros(4, 2), torch.zeros(1, 1, dtype=torch.long),
                     mesh=object())


def test_full_config_matches_the_reference():
    """The full granite-3-2b config (not materialized): every field, and
    the parameter count (~2.5 B)."""
    j, t = j_get_config("granite-3-2b"), get_config("granite-3-2b")
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert t.param_count() == j.param_count()
    assert 2.4e9 < t.param_count() < 2.7e9
    assert (t.hd, t.num_layers, t.d_model) == (64, 40, 2048)


def test_serve_launcher_runs_on_cpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--batch", "2", "--prompt-len", "8", "--gen", "3"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "prefill 2x8" in out.stdout and "decode 2x3" in out.stdout
    assert "on cpu" in out.stdout
