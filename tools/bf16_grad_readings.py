#!/usr/bin/env python3
"""Readings of the dense LM's bfloat16 training gradient: each leaf's
relative L2 distance from the float32 gradient at the same weights (the
bfloat16 weights, widened), under the reference's init or the same draws
scaled to a fan-in init (:func:`rescale_to_fan_in`).

    python3 tools/bf16_grad_readings.py --layers 3 [--width reduced|full]
        [--init reference|fan_in] [--device cuda|cpu] [--batch B]
        [--seq S] [--seed N] [--reference]

granite-3-2b at ``--width`` (``reduced``: d 128, 4 heads of 32; ``full``:
the published widths) cut to ``--layers``.  The weights are drawn by the
reference's rule (std 1/sqrt(shape[0]); a stacked block matrix's first
axis is the layer) from a generator seeded ``--seed``, on the CPU for
``reduced``, so that a run on the card and one on the CPU hold the same
values, and on the device for ``full``; the tokens come from the seeded
Markov source.  The bfloat16 gradient takes the kernel path (the flash
attention and its backward kernel, the bfloat16 projections' autograd
function) on a card and the plain path on the CPU; the float32 gradient
takes the plain path on the same device.  ``--reference`` (CPU, reduced
width) also runs the JAX package's ``lm_loss`` on the same weights and
tokens and prints its distances and the port's distance from its
gradients.  The last line is one JSON object of the readings.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import make_source  # noqa: E402
from repro_torch.models import transformer as TFM  # noqa: E402
from repro_torch.optim.adamw import leaves  # noqa: E402
from repro_torch.parallel.sharding import tree_map  # noqa: E402
from repro_torch.runtime.trainer import loss_and_grads  # noqa: E402

# leading input axes of each block matrix after its layer axis
FAN_IN_AXES = {"wq": 1, "wk": 1, "wv": 1, "wo": 2, "w_gate": 1, "w_up": 1,
               "w_down": 1}


def leaf_names(tree, prefix=""):
    """Leaf paths in :func:`tree_map`'s (sorted-key) order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


def rescale_to_fan_in(params):
    """A dense model's params drawn by the reference's rule, each stacked
    block matrix (std 1/sqrt(L) there) scaled in place to std
    1/sqrt(fan-in), its input width; the embedding, the norms and the
    head are left as drawn.  Returns ``params``."""
    blocks = params["blocks"]
    with torch.no_grad():
        for name, leaf in zip(leaf_names(blocks), leaves(blocks)):
            k = FAN_IN_AXES.get(name.rsplit("/", 1)[-1])
            if k:
                fan = math.prod(leaf.shape[1:1 + k])
                leaf.mul_((leaf.shape[0] / fan) ** 0.5)
    return params


def model_config(width: str, layers: int, dtype: str):
    base = get_config("granite-3-2b")
    if width == "reduced":
        base = base.reduced()
    return dataclasses.replace(base, num_layers=layers, dtype=dtype)


def draw_params(cfg, seed: int, init: str, device):
    """The weights of ``cfg`` by the reference's rule from a generator on
    ``device`` seeded ``seed``, scaled to the fan-in init if ``init`` is
    ``fan_in``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = TFM.init_params(gen, cfg, device)
    return rescale_to_fan_in(params) if init == "fan_in" else params


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def port_grads(params, cfg, tokens, use_kernels: bool):
    loss, _, grads = loss_and_grads(params, cfg, {"tokens": tokens},
                                    use_kernels=use_kernels)
    return float(loss), [g.detach() for g in grads]


def distances(params16, cfg16, tokens):
    """(bfloat16 loss, float32 loss, each leaf's distance of the bfloat16
    gradient from the float32 one, the two gradients): the bfloat16 run
    takes the kernel path on a card, the float32 run the plain path."""
    cfg32 = dataclasses.replace(cfg16, dtype="float32")
    p32 = tree_map(lambda a: a.detach().float(), params16)
    on_card = tokens.device.type == "cuda"
    l16, g16 = port_grads(params16, cfg16, tokens, use_kernels=on_card)
    l32, g32 = port_grads(p32, cfg32, tokens, use_kernels=False)
    names = leaf_names(params16)
    return l16, l32, {n: rel_l2(a, b) for n, a, b in zip(names, g16, g32)}, \
        g16, g32


def reference_readings(params16, cfg16, tokens, g16, g32):
    """The JAX package's bfloat16 and float32 gradients at the same
    weights and tokens (CPU): its distances, and the port's gradients'
    distances from its."""
    import jax
    import jax.numpy as jnp
    import ml_dtypes
    import numpy as np

    from repro.configs import get_config as j_get_config
    from repro.models import transformer as J

    def to_np(a):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return a.numpy()

    jcfg16 = dataclasses.replace(
        j_get_config("granite-3-2b").reduced(),
        num_layers=cfg16.num_layers, dtype=cfg16.dtype)
    jcfg32 = dataclasses.replace(jcfg16, dtype="float32")
    pj16 = jax.tree.map(jnp.asarray, tree_map(to_np, params16))
    pj32 = jax.tree.map(lambda a: a.astype(jnp.float32), pj16)
    batch = {"tokens": jnp.asarray(tokens.cpu().numpy())}
    out = {}
    for key, cfg, p in (("bf16", jcfg16, pj16), ("f32", jcfg32, pj32)):
        (loss, _), g = jax.value_and_grad(
            lambda q: J.lm_loss(q, cfg, batch), has_aux=True)(p)
        out[key] = (float(loss), [torch.from_numpy(
            np.array(x, np.float32)) for x in jax.tree.leaves(g)])
    names = leaf_names(params16)
    jb, jf = out["bf16"][1], out["f32"][1]
    return {
        "loss_bf16": out["bf16"][0], "loss_f32": out["f32"][0],
        "bf16_from_f32": {n: rel_l2(a, b) for n, a, b in zip(names, jb, jf)},
        "port_bf16_from_ref_bf16": {n: rel_l2(a.float(), b) for n, a, b in
                                    zip(names, g16, jb)},
        "port_f32_from_ref_f32": {n: rel_l2(a, b) for n, a, b in
                                  zip(names, g32, jf)}}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--width", choices=("reduced", "full"),
                    default="reduced")
    ap.add_argument("--init", choices=("reference", "fan_in"),
                    default="fan_in")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reference", action="store_true",
                    help="also the JAX package's readings (CPU, reduced)")
    args = ap.parse_args()
    if args.reference and (args.device != "cpu" or args.width != "reduced"):
        raise SystemExit("--reference runs on the CPU at reduced width")
    dev = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg16 = model_config(args.width, args.layers, "bfloat16")
    params = draw_params(cfg16, args.seed, args.init,
                         "cpu" if args.width == "reduced" else dev)
    params = tree_map(lambda a: a.to(dev), params)
    src = make_source("markov", cfg16.vocab_size, args.seq, args.batch,
                      args.seed)
    tokens = torch.from_numpy(src.batch_at(0)).to(dev)
    l16, l32, dist, g16, g32 = distances(params, cfg16, tokens)
    rec = {"width": args.width, "layers": args.layers, "init": args.init,
           "device": str(dev), "batch": args.batch, "seq": args.seq,
           "seed": args.seed, "loss_bf16": l16, "loss_f32": l32,
           "bf16_from_f32": dist}
    print(f"port ({dev}): loss bf16 {l16:.6f}, f32 {l32:.6f}; bf16 "
          f"gradient from f32, rel L2: " + ", ".join(
              f"{n} {x:.4g}" for n, x in dist.items()))
    if args.reference:
        ref = reference_readings(params, cfg16, tokens,
                                 [g.cpu() for g in g16],
                                 [g.cpu() for g in g32])
        rec["reference"] = ref
        print(f"reference (JAX, cpu): loss bf16 {ref['loss_bf16']:.6f}, "
              f"f32 {ref['loss_f32']:.6f}; bf16 gradient from f32, rel L2: "
              + ", ".join(f"{n} {x:.4g}"
                          for n, x in ref["bf16_from_f32"].items()))
        print("port bf16 gradient from the reference's bf16 gradient: "
              + ", ".join(f"{n} {x:.4g}" for n, x in
                          ref["port_bf16_from_ref_bf16"].items()))
        print("port f32 gradient from the reference's f32 gradient: "
              + ", ".join(f"{n} {x:.4g}" for n, x in
                          ref["port_f32_from_ref_f32"].items()))
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
