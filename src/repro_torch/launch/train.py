"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \
      --reduced --device cpu --steps 50 --batch 8 --seq 128 [--ckpt-dir ckpt/]

Counterpart of `repro.launch.train`: ``--device cuda`` (the default) or
``cpu``.  ``--reduced`` shrinks the architecture to a CPU-runnable width
(same code path as production).  ``--mesh`` trains SPMD under the
production sharding rules (`DEFAULT_RULES`: FSDP over ``data``, TP and
the sequence-split residual over ``model``) on a mesh over the process
group that ``torchrun`` started:

  torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch \
      zamba2-7b --reduced --mesh host --mesh-shape 2,2

``host`` is `launch.mesh.make_host_mesh` over the group's ranks
(``--mesh-shape data,model``, default (1, world)); ``pod`` and
``multipod`` are `make_production_mesh` (whole nodes of 8 cards).  The
group's backend is NCCL on ``--device cuda`` with one card a rank, gloo
on ``cpu``.  Without a process group to join, ``--mesh`` raises: it
never falls back to one device.
"""
from __future__ import annotations

import argparse
import os

from repro_torch.configs.base import get_config, reduced_config
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.training.trainer import Trainer, TrainerConfig


def make_mesh(kind: str, shape=None, device: str = "cuda"):
    """The training mesh of ``--mesh``: None for "none"; else one over
    the process group, which this joins from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``) unless it is up."""
    if kind == "none":
        return None
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    if not dist.is_initialized():
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise RuntimeError(
                f"--mesh {kind} needs a process group: start the ranks with "
                "torchrun (RANK and WORLD_SIZE are not set)")
        backend = "nccl" if device == "cuda" else "gloo"
        if device == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend)
    if kind == "host":
        data, model = shape or (1, dist.get_world_size())
        return make_host_mesh(data, model)
    return make_production_mesh(multi_pod=kind == "multipod")


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
    ap.add_argument("--mesh", choices=["none", "host", "pod", "multipod"],
                    default="none")
    ap.add_argument("--mesh-shape", default=None,
                    help="data,model for --mesh host")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    shape = (tuple(int(v) for v in args.mesh_shape.split(","))
             if args.mesh_shape else None)
    mesh = make_mesh(args.mesh, shape, args.device)

    tc = TrainerConfig(batch=args.batch, seq=args.seq, steps=args.steps,
                       ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
                       sdc_every=args.sdc_every)
    tr = Trainer(cfg, AdamWConfig(lr=args.lr, warmup_steps=10,
                                  total_steps=args.steps), tc, mesh=mesh,
                 device=args.device)
    tr.init()
    hist = tr.run()
    print(f"final loss: {hist[-1]['loss']:.4f} after {len(hist)} steps")
    return hist


if __name__ == "__main__":
    main()
