"""Serving launcher: continuous batching with (d, p, w) publication.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
      --reduced --device cpu --requests 8 --max-new 8

Counterpart of `repro.launch.serve`.  ``--device`` is "cuda" by default
(and raises without a card); "cpu" runs the plain PyTorch paths.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs.base import get_config, reduced_config
from repro_torch.models import model as M
from repro_torch.parallel.sharding import init_params
from repro_torch.serving.engine import ServeConfig, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    params = init_params(args.seed, M.model_param_specs(cfg),
                         device=args.device)
    eng = ServingEngine(cfg, params, ServeConfig(slots=args.slots,
                                                 max_len=256),
                        device=args.device)
    rng = np.random.RandomState(args.seed)
    for _ in range(args.requests):
        p = rng.randint(0, cfg.vocab_size, size=rng.randint(3, 17))
        eng.submit(p.astype(np.int32), max_new=args.max_new)
    reqs = list(eng.queue)
    t0 = time.monotonic()
    ticks = 0
    while (eng.queue or eng.active) and ticks < 10_000:
        eng.step()
        ticks += 1
    dt = time.monotonic() - t0
    toks = sum(len(r.out_tokens) for r in reqs)
    print(f"served {len(reqs)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks / max(dt, 1e-9):.1f} tok/s on {eng.device.type})")
    print("published (d,p,w) units per prompt bucket:")
    for b, row in sorted(eng.published_units().items()):
        print(f"  bucket<={b}: d={row['d']:.0f}B p={row['p']} "
              f"w={row['w']:.3f}s")


if __name__ == "__main__":
    main()
