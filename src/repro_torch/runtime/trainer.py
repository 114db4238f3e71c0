"""The LM training loop (port of ``repro.runtime.trainer``): auto-resume,
atomic checkpoints, straggler monitoring, gradient accumulation over
microbatches and int8 error-feedback gradient compression.

Fault tolerance: a restart re-enters :func:`train`; ``latest_valid_step``
finds the newest intact checkpoint, and the seekable data source resumes
at that step bit for bit.  Every kernel of a step is deterministic (the
flash backward uses no float atomics), so a resumed run repeats the
uninterrupted run's bits.  Steps slower than ``straggler_factor`` times an
EWMA of the step time are flagged and counted.

The step runs eagerly on one device (the reference jits it over a mesh):
``mesh=`` is refused, naming its ROADMAP item.  The dense family trains;
the ssm and hybrid families are refused by :func:`~repro_torch.models.
transformer.lm_loss`.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import store
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import make_source
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw
from repro_torch.parallel.collectives import compress_tree
from repro_torch.parallel.sharding import tree_map

MESH_ITEM = ("ROADMAP §1, still to port: the rest of the LM substrate "
             "(training on a mesh)")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    batch: int = 8
    seq_len: int = 64
    ckpt_every: int = 20
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_keep: int = 3
    data: str = "markov"
    seed: int = 0
    microbatches: int = 1        # gradient accumulation
    remat: bool = True
    log_every: int = 10
    straggler_factor: float = 3.0
    opt: adamw.OptConfig = adamw.OptConfig()


def loss_and_grads(params, cfg: ModelConfig, batch: dict, *,
                   remat: bool = True, use_kernels: bool = True):
    """(loss, metrics, the gradient leaves in :func:`adamw.leaves` order,
    each in its parameter's dtype) of :func:`~repro_torch.models.
    transformer.lm_loss`; the parameters are made to require grad."""
    leaves = adamw.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = tfm.lm_loss(params, cfg, batch, remat=remat,
                                use_kernels=use_kernels)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        list(grads)


def _rebuild(tree, flat):
    """``flat`` (leaves in :func:`adamw.leaves` order) in ``tree``'s
    structure."""
    it = iter(flat)
    return tree_map(lambda _: next(it), tree)


def make_train_step(cfg: ModelConfig, tc: TrainConfig):
    """The step ``(params, opt_state, batch) -> (params, opt_state,
    metrics)``; params and state are updated in place.  With
    ``microbatches`` > 1 the batch is cut into that many equal parts whose
    float32 gradients are summed and averaged, and the metrics are the
    last part's, as in the reference.  The attention runs its kernels on
    CUDA tensors (:func:`~repro_torch.models.transformer.lm_loss`)."""
    tfm.check_trainable(cfg)
    oc = tc.opt

    def train_step(params, opt_state, batch):
        if tc.microbatches > 1:
            M = tc.microbatches
            mb = batch["tokens"].shape[0] // M
            gsum, lsum = None, 0.0
            for i in range(M):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                loss, metrics, g = loss_and_grads(params, cfg, part,
                                                  remat=tc.remat)
                g = [x.to(torch.float32) for x in g]
                gsum = g if gsum is None else [a + b for a, b in
                                               zip(gsum, g)]
                lsum = lsum + loss
            flat = [a / M for a in gsum]
            loss = lsum / M
        else:
            loss, metrics, flat = loss_and_grads(params, cfg, batch,
                                                 remat=tc.remat)
        grads = _rebuild(params, flat)
        if oc.compress_grads:
            grads, ef = compress_tree(grads, opt_state.ef, axis=None)
            opt_state = opt_state._replace(ef=ef)
        params, opt_state, om = adamw.apply_updates(params, opt_state,
                                                    grads, oc)
        return params, opt_state, dict(metrics, loss=loss, **om)

    return train_step


@dataclasses.dataclass
class StragglerMonitor:
    factor: float = 3.0
    alpha: float = 0.2
    ewma: float | None = None
    flags: int = 0

    def observe(self, dt: float) -> bool:
        if self.ewma is None:
            self.ewma = dt
            return False
        slow = dt > self.factor * self.ewma
        if slow:
            self.flags += 1
        else:  # stragglers do not poison the baseline
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return slow


def _state_template(cfg: ModelConfig, oc: adamw.OptConfig):
    """The tree a checkpoint restores into: {"params", "opt"}, its leaves
    the parameters' specs (only the structure is read)."""
    p = tfm.abstract_params(cfg)
    return {"params": p, "opt": adamw.OptState(
        0, p, p, p, p if oc.compress_grads else None)}


def train(cfg: ModelConfig, tc: TrainConfig, mesh=None, stop_after=None,
          *, device="cuda"):
    """Run (or resume) training on ``device``; a fresh run draws its
    weights from ``tc.seed`` (:func:`~repro_torch.models.transformer.
    init_params`).  Returns (params, opt_state, history)."""
    if mesh is not None:
        raise NotImplementedError(f"train(mesh=...): {MESH_ITEM}")
    tfm.check_trainable(cfg)
    source = make_source(tc.data, cfg.vocab_size, tc.seq_len, tc.batch,
                         tc.seed)
    start = store.latest_valid_step(tc.ckpt_dir)
    if start is None:
        gen = torch.Generator(device=device).manual_seed(tc.seed)
        params = tfm.init_params(gen, cfg, device)
        opt_state = adamw.init(params, tc.opt)
        start = 0
    else:
        restored = store.restore(tc.ckpt_dir, start,
                                 _state_template(cfg, tc.opt), device)
        params, opt_state = restored["params"], restored["opt"]

    step_fn = make_train_step(cfg, tc)
    monitor = StragglerMonitor(tc.straggler_factor)
    history = []
    for step in range(start, tc.steps):
        batch = {"tokens": torch.from_numpy(source.batch_at(step))
                 .to(device)}
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        slow = monitor.observe(dt)
        history.append({"step": step, "loss": loss, "dt": dt,
                        "straggler": slow})
        if tc.log_every and step % tc.log_every == 0:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"dt {dt*1e3:.0f}ms{'  [STRAGGLER]' if slow else ''}")
        done = step + 1
        if done % tc.ckpt_every == 0 or done == tc.steps:
            store.save(tc.ckpt_dir, done,
                       {"params": params, "opt": opt_state},
                       extra={"arch": cfg.name}, keep=tc.ckpt_keep)
        if stop_after is not None and done - start >= stop_after:
            break
    return params, opt_state, history
