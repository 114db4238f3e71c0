"""Training launcher (port of ``repro.launch.train``):

    python -m repro_torch.launch.train --arch granite-3-2b \\
        --size reduced|100m|full [--steps 100] [--device cpu]

Runs the training loop (:func:`repro_torch.runtime.trainer.train`) on the
card unless ``--device cpu``, resuming from the newest valid checkpoint in
``--ckpt-dir``.  ``reduced`` is the config's small variant (vocab at
least 512), ``100m`` its ~100 M-parameter variant (:func:`scale_to_100m`)
and ``full`` the published widths and depth.  The dense family trains
(granite-3-2b); rwkv6 and zamba2 are refused, naming their ROADMAP item.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile


def scale_to_100m(cfg):
    """Shrink a full config to ~100 M parameters, keeping its family (the
    port's copy of ``examples/train_lm.py``'s)."""
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-100m",
        num_layers=min(cfg.num_layers, 12 if cfg.family != "hybrid"
                       else 2 * cfg.attn_every),
        d_model=768,
        num_heads=min(cfg.num_heads, 12) if cfg.num_heads else 0,
        num_kv_heads=min(cfg.num_kv_heads, 4) if cfg.num_heads else 0,
        head_dim=64 if cfg.num_heads else 0,
        d_ff=2304 if not cfg.num_experts else 768,
        vocab_size=16384,
        num_experts=min(cfg.num_experts, 8),
        experts_per_tok=min(cfg.experts_per_tok, 2),
        moe_capacity_factor=2.0,
        sliding_window=min(cfg.sliding_window, 1024) or 0,
        dtype="float32",
    )


def sized_config(arch: str, size: str):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if size == "reduced":
        cfg = cfg.reduced()
        cfg = dataclasses.replace(cfg, vocab_size=max(cfg.vocab_size, 512))
    elif size == "100m":
        cfg = scale_to_100m(cfg)
    return cfg


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--size", choices=["reduced", "100m", "full"],
                    default="reduced")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda)")
    args = ap.parse_args(argv)

    from repro_torch.optim.adamw import OptConfig
    from repro_torch.runtime.trainer import TrainConfig, train

    cfg = sized_config(args.arch, args.size)
    print(f"arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M "
          f"device={args.device}")
    tc = TrainConfig(
        steps=args.steps, batch=args.batch, seq_len=args.seq,
        ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
        microbatches=args.microbatches, log_every=10,
        opt=OptConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                      total_steps=args.steps,
                      compress_grads=args.compress_grads))
    _, _, hist = train(cfg, tc, device=args.device)
    print(f"done: loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
