"""The port's training loop (``repro_torch.runtime.trainer``), checkpoint
store (``repro_torch.checkpoint.store``) and launcher
(``python -m repro_torch.launch.train``) against the JAX package's, float32
on the CPU, on a 2-layer granite-3-2b cut to d 64 (the reference's
``tests/test_runtime.py`` ``tiny_cfg``).

Tolerances: three training steps from the same weights and batches give
each step's loss within rtol 1e-5 of the reference's (the largest
distance seen is 1.4e-6), its gradient norm within rtol 5e-3 and every
parameter leaf within a relative L2 distance of 1e-3.  The gradients are
ill-conditioned under the reference's init: a random relative change of
1e-7 in the reference's own weights moves its gradients by up to 1.4e-4
(relative L2, per leaf), so the two packages' float32 sums in other
orders do as much, and the gap grows over the steps (AdamW's first steps
move an element by about lr whatever its gradient's size, so a gradient
near 0 whose sign the sums' order flips moves apart by up to 2 lr); with
compressed gradients an element on an int8 rounding boundary also
flips, so the error-feedback residuals (that rounding's noise) are held
to the reference's only in size.  Seen: gradient norms 6e-4 apart at step
1 (3.7e-3 compressed at step 2), parameters 3.7e-4 apart at most (the
compressed embedding).
Gradient accumulation over 2 microbatches against the full batch:
the reference's own tolerance (rtol 2e-4, atol 2e-5,
``tests/test_runtime.py:150``).  Checkpoints cross between the packages
bitwise, and a crashed and resumed run repeats the uninterrupted run's
bits.
"""
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as JS
from repro.configs import get_config as j_get_config
from repro.data.pipeline import make_source
from repro.models import transformer as J
from repro.optim import adamw as JA
from repro.runtime import trainer as JT
from repro_torch.checkpoint import store as TS
from repro_torch.configs import get_config
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as TA
from repro_torch.parallel.sharding import tree_map
from repro_torch.runtime import trainer as TT
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

TINY = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2,
            head_dim=32, d_ff=128, vocab_size=128)


def tiny_cfgs():
    j = dataclasses.replace(j_get_config("granite-3-2b").reduced(), **TINY)
    t = dataclasses.replace(get_config("granite-3-2b").reduced(), **TINY)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def tree_np(tree):
    return jax.tree.map(np.asarray, tree)


VARIANTS = {"full": {}, "microbatches2": {"microbatches": 2},
            "compress_grads": {"compress": True}}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_three_train_steps_match_jax(variant):
    """make_train_step of both packages, three steps from the reference's
    initial weights and optimizer state (carried across), on the seeded
    Markov batches: each step's loss, grad norm, and the parameters and
    master weights after the third step."""
    kw = dict(VARIANTS[variant])
    compress = kw.pop("compress", False)
    jcfg, tcfg = tiny_cfgs()
    oc = dict(lr=1e-3, warmup_steps=2, total_steps=3,
              compress_grads=compress)
    jtc = JT.TrainConfig(batch=4, seq_len=16, opt=JA.OptConfig(**oc), **kw)
    ttc = TT.TrainConfig(batch=4, seq_len=16, opt=TA.OptConfig(**oc), **kw)
    jp = J.init_params(jax.random.PRNGKey(0), jcfg)
    js = JA.init(jp, jtc.opt)
    tp = T.params_from_numpy(tree_np(jp), "cpu")
    ts = T.opt_state_from_numpy(tree_np(js), "cpu")
    jstep = jax.jit(JT.make_train_step(jcfg, jtc))
    tstep = TT.make_train_step(tcfg, ttc)
    src = make_source("markov", jcfg.vocab_size, 16, 4, seed=0)
    for step in range(3):
        toks = src.batch_at(step)
        jp, js, jm = jstep(jp, js, {"tokens": jnp.asarray(toks)})
        tp, ts, tm = tstep(tp, ts, {"tokens": torch.from_numpy(toks)})
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5 if k == "loss" else 5e-3)
    for want, got in ((jp, tp), (js.master, ts.master)):
        for a, b in zip(jax.tree.leaves(tree_np(want)), TA.leaves(got)):
            rel = np.linalg.norm(b.detach().numpy() - a) / np.linalg.norm(a)
            assert rel < 1e-3, (a.shape, rel)
    if compress:  # the residuals are rounding noise of one scale
        for a, b in zip(jax.tree.leaves(tree_np(js.ef)), TA.leaves(ts.ef)):
            ratio = np.linalg.norm(b.numpy()) / np.linalg.norm(a)
            assert a.shape == b.shape and 0.5 < ratio < 2, ratio


def test_gradient_accumulation_matches_full_batch():
    """The port alone, as the reference's
    ``test_gradient_accumulation_matches_full_batch``: one step over 4
    microbatches against one over the whole batch."""
    _, cfg = tiny_cfgs()
    toks = torch.from_numpy(make_source("markov", cfg.vocab_size, 32, 8,
                                        seed=1).batch_at(0))
    params = T.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    oc = TA.OptConfig(lr=1e-3)
    out = []
    for m in (1, 4):
        p = tree_map(lambda a: a.clone(), params)
        tc = TT.TrainConfig(microbatches=m, opt=oc, remat=False)
        p, _, _ = TT.make_train_step(cfg, tc)(p, TA.init(p, oc),
                                             {"tokens": toks})
        out.append(p)
    for a, b in zip(TA.leaves(out[0]), TA.leaves(out[1])):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=2e-4, atol=2e-5)


def ckpt_tree(seed):
    rng = np.random.default_rng(seed)
    bf = jnp.asarray(rng.normal(size=(3, 5)).astype(np.float32)) \
        .astype(jnp.bfloat16)
    return {"params": {"w": np.asarray(bf),
                       "b": rng.normal(size=(4,)).astype(np.float32)},
            "opt": JA.OptState(np.int32(7),
                               {"w": rng.normal(size=(3, 5)).astype(
                                   np.float32),
                                "b": np.ones(4, np.float32)},
                               {"w": np.zeros((3, 5), np.float32),
                                "b": np.zeros(4, np.float32)},
                               {"w": np.zeros((3, 5), np.float32),
                                "b": np.zeros(4, np.float32)}, None)}


def same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and str(a.dtype) == str(b.dtype)
    assert a.tobytes() == b.tobytes()


def torch_to_np(x):
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(jnp.bfloat16)
    return x.numpy()


def test_checkpoints_cross_between_the_packages_bitwise(tmp_path):
    """A checkpoint the JAX package writes restores in the port, and one
    the port writes restores in the JAX package, bit for bit (bfloat16,
    float32 and the int32 step, the OptState's fields by index, its None
    ``ef`` absent), with the same manifest keys."""
    tree = ckpt_tree(0)
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    JS.save(jdir, 3, tree, extra={"arch": "x"})
    template = {"params": {"w": 0, "b": 0},
                "opt": TA.OptState(0, {"w": 0, "b": 0}, {"w": 0, "b": 0},
                                   {"w": 0, "b": 0}, None)}
    assert TS.latest_valid_step(jdir) == 3
    got = TS.restore(jdir, 3, template, "cpu")
    for a, b in zip(jax.tree.leaves(tree), TA.leaves(got)):
        same_bits(torch_to_np(b), a)
    TS.save(tdir, 3, got, extra={"arch": "x"})
    assert TS.read_manifest(tdir, 3)["keys"] == \
        JS.read_manifest(jdir, 3)["keys"]
    assert TS.read_manifest(tdir, 3)["dtypes"] == \
        JS.read_manifest(jdir, 3)["dtypes"]
    back = JS.restore(tdir, 3, jax.tree.map(jnp.asarray, tree))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        same_bits(b, a)


def test_checkpoint_atomic_validated_and_garbage_collected(tmp_path):
    """A torn payload fails its hash and the newest valid step is the one
    before it; ``keep`` keeps the newest N; an unfinished ``.tmp`` is not
    a step."""
    d = str(tmp_path / "ck")
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": torch.ones(4, dtype=torch.bfloat16)}
    TS.save(d, 1, tree)
    TS.save(d, 2, tree)
    with open(os.path.join(d, "step_2", "arrays.npz"), "r+b") as f:
        f.seek(30)
        f.write(b"\xde\xad")
    assert TS.latest_valid_step(d) == 1
    with pytest.raises(IOError):
        TS.restore(d, 2, tree, "cpu")
    got = TS.restore(d, 1, tree, "cpu")
    assert torch.equal(got["w"], tree["w"]) and got["b"].dtype == \
        torch.bfloat16
    os.makedirs(os.path.join(d, "step_9.tmp"))
    for s in range(3, 6):
        TS.save(d, s, tree, keep=2)
    assert sorted(TS.all_steps(d)) == [4, 5]


def test_crash_and_resume_repeat_the_uninterrupted_run_bitwise(tmp_path):
    """The port's train: 6 steps uninterrupted, against 3 steps (the
    newest checkpoint at step 2), a restart from it and the rest: the
    resumed steps' losses and the final parameters and optimizer state
    are bitwise the uninterrupted run's."""
    _, cfg = tiny_cfgs()

    def tc(d):
        return TT.TrainConfig(steps=6, batch=2, seq_len=16, ckpt_every=2,
                              ckpt_dir=str(d), log_every=0,
                              opt=TA.OptConfig(lr=1e-3, warmup_steps=2,
                                               total_steps=6))
    pa, sa, ha = TT.train(cfg, tc(tmp_path / "a"), device="cpu")
    TT.train(cfg, tc(tmp_path / "b"), stop_after=3, device="cpu")
    assert TS.latest_valid_step(str(tmp_path / "b")) == 2
    pb, sb, hb = TT.train(cfg, tc(tmp_path / "b"), device="cpu")
    assert [h["step"] for h in hb] == [2, 3, 4, 5]
    assert [h["loss"] for h in hb] == [h["loss"] for h in ha[2:]]
    for a, b in zip(TA.leaves((pa, sa)), TA.leaves((pb, sb))):
        assert torch.equal(a, b)


def test_train_draws_its_weights_from_the_seed_and_logs(tmp_path, capsys):
    """A fresh run's weights are ``init_params`` from ``tc.seed`` (two
    runs from one seed agree bitwise, another seed differs); a step is
    logged every ``log_every``; the last step checkpoints."""
    _, cfg = tiny_cfgs()

    def run(name, seed):
        tc = TT.TrainConfig(steps=2, batch=2, seq_len=16, ckpt_every=10,
                            ckpt_dir=str(tmp_path / name), log_every=1,
                            seed=seed)
        p, _, hist = TT.train(cfg, tc, device="cpu")
        assert len(hist) == 2 and TS.latest_valid_step(tc.ckpt_dir) == 2
        return p
    a, b, c = run("a", 0), run("b", 0), run("c", 1)
    assert torch.equal(a["lm_head"], b["lm_head"])
    assert not torch.equal(a["lm_head"], c["lm_head"])
    assert capsys.readouterr().out.count("loss") == 6


def test_straggler_monitor_flags_outliers():
    """The reference's case (``tests/test_runtime.py:124``), and the
    same flags as the reference's monitor on a random series."""
    m = TT.StragglerMonitor(factor=3.0)
    flags = [m.observe(dt) for dt in [1.0, 1.1, 0.9, 1.0, 5.0, 1.0, 1.05]]
    assert flags == [False, False, False, False, True, False, False]
    assert m.flags == 1 and m.ewma < 1.5
    dts = np.random.default_rng(0).lognormal(0, 0.8, 200).tolist()
    jm, tm = JT.StragglerMonitor(), TT.StragglerMonitor()
    assert [jm.observe(d) for d in dts] == [tm.observe(d) for d in dts]
    assert (jm.flags, jm.ewma) == (tm.flags, tm.ewma)


def test_launcher_trains_and_resumes_on_the_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train --size reduced --device cpu``
    in-process: two steps, then a second call finds the checkpoint and
    runs the rest.  The 100m size keeps the reference's shape."""
    argv = ["--size", "reduced", "--steps", "3", "--batch", "2", "--seq",
            "16", "--ckpt-every", "2", "--device", "cpu",
            "--ckpt-dir", str(tmp_path / "l")]
    launch_train.main(argv[:3] + ["2"] + argv[4:])
    assert TS.latest_valid_step(str(tmp_path / "l")) == 2
    launch_train.main(argv)
    out = capsys.readouterr().out
    assert out.count("done: loss") == 2 and "device=cpu" in out
    assert TS.latest_valid_step(str(tmp_path / "l")) == 3
    spec = importlib.util.spec_from_file_location(
        "train_lm", os.path.join(ROOT, "examples", "train_lm.py"))
    train_lm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(train_lm)
    full = get_config("granite-3-2b")
    assert dataclasses.asdict(launch_train.scale_to_100m(full)) == \
        dataclasses.asdict(train_lm.scale_to_100m(
            j_get_config("granite-3-2b")))
