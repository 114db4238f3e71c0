"""The port's optimizer, gradient compression and data sources against the
JAX package's (``repro_torch.optim.adamw``, ``repro_torch.parallel.
collectives``, ``repro_torch.data.pipeline``), on the same numpy inputs,
float32 on the CPU.

Tolerances: one AdamW step's parameters, master and moments within rtol
1e-6 / atol 1e-7 of the reference's (the same float32 arithmetic; XLA may
contract a product and a sum into one rounding), its gradient norm and
learning rate rtol 1e-6.  The int8 quantization is bitwise (the same
rounding of the same float32 quotient).  The data sources are numpy in
both packages: bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as JD
from repro.optim import adamw as JA
from repro.parallel import collectives as JC
from repro_torch.data import pipeline as TD
from repro_torch.models.transformer import opt_state_from_numpy
from repro_torch.optim import adamw as TA
from repro_torch.parallel import collectives as TC
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port


def tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def grads_and_params(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    params = {"a": {"w": rng.normal(size=(3, 8, 4)).astype(dtype)},
              "b": rng.normal(size=(5,)).astype(dtype)}
    grads = {"a": {"w": (rng.normal(size=(3, 8, 4)) * 2).astype(dtype)},
             "b": (rng.normal(size=(5,)) * 2).astype(dtype)}
    return params, grads


def torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_apply_updates_matches_jax(schedule, clip):
    """Three AdamW steps from a state carried across
    (``opt_state_from_numpy``), the gradient clipped (norm ~12 against
    1.0) or not, warmup 2 of 6 steps so the schedule's every branch runs:
    params, master, moments, step, grad_norm and lr."""
    oc_kw = dict(lr=1e-2, warmup_steps=2, total_steps=6, schedule=schedule,
                 clip_norm=clip)
    joc, toc = JA.OptConfig(**oc_kw), TA.OptConfig(**oc_kw)
    params, _ = grads_and_params(0)
    jp = jax.tree.map(jnp.asarray, params)
    js = JA.init(jp, joc)
    tp = torch_tree(params)
    ts = opt_state_from_numpy(tree_np(js), "cpu")
    for step in range(3):
        _, grads = grads_and_params(step + 1)
        jp, js, jm = JA.apply_updates(jp, js, jax.tree.map(jnp.asarray,
                                                           grads), joc)
        tp, ts, tm = TA.apply_updates(tp, ts, torch_tree(grads), toc)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-6)
    assert int(ts.step) == int(js.step) == 3
    for want, got in ((jp, tp), (js.master, ts.master), (js.mu, ts.mu),
                      (js.nu, ts.nu)):
        for a, b in zip(jax.tree.leaves(tree_np(want)), TA.leaves(got)):
            np.testing.assert_allclose(b.numpy(), a, rtol=1e-6, atol=1e-7)


def test_init_copies_into_float32_and_bfloat16_params_follow_master():
    """The master never aliases a float32 parameter; bfloat16 parameters
    are the master rounded, as the reference's ``m.astype(p.dtype)``."""
    p = {"w": torch.randn(4, 3).bfloat16(), "x": torch.randn(3)}
    oc = TA.OptConfig(lr=1e-1, warmup_steps=1)
    st = TA.init(p, oc)
    assert st.master["x"].data_ptr() != p["x"].data_ptr()
    assert st.master["w"].dtype == torch.float32 and st.ef is None
    g = {"w": torch.ones(4, 3).bfloat16(), "x": torch.ones(3)}
    p, st, _ = TA.apply_updates(p, st, g, oc)
    assert torch.equal(p["w"], st.master["w"].bfloat16())
    assert torch.equal(p["x"], st.master["x"])
    assert TA.init(p, TA.OptConfig(compress_grads=True)).ef is not None


def test_apply_updates_slabs_a_large_leaf_like_one_pass(monkeypatch):
    """A leaf above the slab size is updated a slab of its leading axis at
    a time: bitwise the one-pass update."""
    rng = np.random.default_rng(3)
    p0 = {"w": rng.normal(size=(6, 5, 4)).astype(np.float32)}
    g = {"w": rng.normal(size=(6, 5, 4)).astype(np.float32)}
    out = []
    for slab in (1 << 24, 40):  # one pass; 2 rows of 20 elements a slab
        monkeypatch.setattr(TA, "SLAB", slab)
        p = torch_tree(p0)
        st = TA.init(p, TA.OptConfig())
        p, st, m = TA.apply_updates(p, st, torch_tree(g), TA.OptConfig())
        out.append((p["w"].clone(), st.nu["w"].clone(), m["grad_norm"]))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_quantize_and_compressed_psum_match_jax_bitwise():
    rng = np.random.default_rng(5)
    g = rng.normal(size=(64,)).astype(np.float32)
    r = (rng.normal(size=(64,)) * 1e-3).astype(np.float32)
    jq, js = JC.quantize_int8(jnp.asarray(g))
    tq, ts = TC.quantize_int8(torch.from_numpy(g))
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    assert np.array_equal(TC.dequantize_int8(tq, ts).numpy(),
                          np.asarray(JC.dequantize_int8(jq, js)))
    jd, jr = JC.compressed_psum(jnp.asarray(g), jnp.asarray(r), None)
    td, tr = TC.compressed_psum(torch.from_numpy(g), torch.from_numpy(r),
                                None)
    assert np.array_equal(td.numpy(), np.asarray(jd))
    assert np.array_equal(tr.numpy(), np.asarray(jr))
    grads = {"a": g, "b": {"c": g[:8] * 3}}
    res = {"a": r, "b": {"c": r[:8]}}
    jg, jres = JC.compress_tree(jax.tree.map(jnp.asarray, grads),
                                jax.tree.map(jnp.asarray, res), None)
    tg, tres = TC.compress_tree(torch_tree(grads), torch_tree(res), None)
    for a, b in zip(jax.tree.leaves(tree_np((jg, jres))),
                    TA.leaves((tg, tres))):
        assert np.array_equal(b.numpy(), a)
    with pytest.raises(NotImplementedError, match="LM substrate"):
        TC.compressed_psum(torch.from_numpy(g), torch.from_numpy(r), "dp")


@pytest.mark.parametrize("kind", ["uniform", "markov"])
def test_data_sources_match_jax_bitwise(kind):
    for seed, step in ((0, 0), (7, 11), (3, 1000)):
        a = JD.make_source(kind, 128, 32, 4, seed).batch_at(step)
        b = TD.make_source(kind, 128, 32, 4, seed).batch_at(step)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError):
        TD.make_source("zipf", 128, 32, 4)
