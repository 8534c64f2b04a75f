"""End-to-end serving driver on the PyTorch port: batched requests
through the continuous-batching engine, with the paper's (d, p, w) units
published per bucket.

The counterpart of `examples/serve_lm.py` on `repro_torch`: the same
requests (prompts drawn from seed 7), random weights from seed 0.  Runs
on the card unless ``--device cpu`` is given.

  PYTHONPATH=src python examples/port_serve_lm.py [--arch qwen3-14b]
      [--device cuda|cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.configs.base import get_config, reduced_config
from repro_torch.models import model as M
from repro_torch.parallel.sharding import init_params
from repro_torch.serving.engine import ServeConfig, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = reduced_config(get_config(args.arch))
    params = init_params(0, M.model_param_specs(cfg), device=args.device)
    eng = ServingEngine(cfg, params, ServeConfig(slots=4, max_len=128),
                        device=args.device)

    rng = np.random.RandomState(7)
    for i in range(args.requests):
        plen = int(rng.choice([4, 8, 24]))
        eng.submit(rng.randint(0, cfg.vocab_size, plen).astype(np.int32),
                   max_new=8)
    reqs = list(eng.queue)
    t0 = time.monotonic()
    while eng.queue or eng.active:
        eng.step()
    dt = time.monotonic() - t0
    toks = sum(len(r.out_tokens) for r in reqs)
    lat = [r.finished - r.arrived for r in reqs]
    print(f"{args.arch} (reduced): {len(reqs)} reqs, {toks} tokens, "
          f"{dt:.2f}s wall, p50 latency {sorted(lat)[len(lat) // 2]:.2f}s")
    print("published (d,p,w) per prompt bucket "
          "(the tracker-list analogue for admission):")
    for b, row in sorted(eng.published_units().items()):
        print(f"  bucket<={b:3d}: d={row['d']:7.0f}B p={row['p']:2d} "
              f"w={row['w']:.3f}s")


if __name__ == "__main__":
    main()
