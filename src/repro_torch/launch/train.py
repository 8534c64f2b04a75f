"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \
      --reduced --device cpu --steps 50 --batch 8 --seq 128 [--ckpt-dir ckpt/]

Counterpart of `repro.launch.train` on one device: ``--device cuda`` (the
default) or ``cpu``.  ``--reduced`` shrinks the architecture to a
CPU-runnable width (same code path as production).  There is no
``--mesh``: the sharded train step comes with the next mesh slice
(serving over a mesh is `training.train_state.make_decode_step(cfg,
mesh)` and `ServingEngine(..., mesh=)`).
"""
from __future__ import annotations

import argparse

from repro_torch.configs.base import get_config, reduced_config
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.training.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--sdc-every", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)

    tc = TrainerConfig(batch=args.batch, seq=args.seq, steps=args.steps,
                       ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
                       sdc_every=args.sdc_every)
    tr = Trainer(cfg, AdamWConfig(lr=args.lr, warmup_steps=10,
                                  total_steps=args.steps), tc,
                 device=args.device)
    tr.init()
    hist = tr.run()
    print(f"final loss: {hist[-1]['loss']:.4f} after {len(hist)} steps")
    return hist


if __name__ == "__main__":
    main()
