"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> ...``
(port of ``repro.launch.serve``).

Prefill + batched greedy decode, on the card unless ``--device cpu``:
granite-3-2b (the default) with the ring-buffer KV cache, rwkv6-1.6b
with each layer's recurrent state, zamba2-2.7b with both (a ring KV slot
per superblock, each Mamba2 layer's conv and SSD state).  As the reference, it serves the reduced
config (``cfg.reduced()``) with random weights from ``--seed``; the first
decode step feeds the prompt's last token again, as the reference does.
"""
from __future__ import annotations

import argparse
import time

import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm

    dev = torch.device(args.device)
    cfg = get_config(args.arch).reduced()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = tfm.init_params(gen, cfg, dev)
    B, P, G = args.batch, args.prompt_len, args.gen
    prompt_gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=prompt_gen,
                            dtype=torch.int32, device=dev)
    cache = tfm.init_cache(cfg, B, tfm.cache_slots(cfg, P + G), dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with torch.inference_mode():
        sync()
        t0 = time.perf_counter()
        _, cache = tfm.prefill(params, cfg, cache, {"tokens": prompts})
        sync()
        print(f"prefill {B}x{P}: {(time.perf_counter()-t0)*1e3:.0f} ms")
        tok = prompts[:, -1:]
        t0 = time.perf_counter()
        for _ in range(G):
            nxt, cache = tfm.serve_step(params, cfg, cache, tok)
            tok = nxt[:, None]
        sync()
        dt = time.perf_counter() - t0
    print(f"decode {B}x{G}: {dt*1e3:.0f} ms ({B*G/dt:.0f} tok/s) on "
          f"{dev.type}; last tokens {tok[:, 0].tolist()}")


if __name__ == "__main__":
    main()
