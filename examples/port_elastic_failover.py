"""Fault-tolerance walkthrough on the PyTorch port: train, kill a member,
re-mesh, resume.

The counterpart of `examples/elastic_failover.py` on `repro_torch`.  The
paper's liveness (t, f) + lease machinery drives the framework's elastic
restart: checkpoints survive, leases re-queue, the mesh plan shrinks to
the largest balanced pod count, and training resumes from the last
committed step with bit-identical state.  Runs on the card unless
``--device cpu`` is given.

  PYTHONPATH=src python examples/port_elastic_failover.py
      [--device cuda|cpu]
"""
import argparse
import tempfile

import torch

from repro_torch.configs.base import get_config, reduced_config
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel.sharding import tree_leaves_with_path
from repro_torch.training.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ckpt = tempfile.mkdtemp(prefix="elastic_ckpt_")
    cfg = reduced_config(get_config("qwen3-14b"))
    opt = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=40)

    print("phase 1: 8-pod job trains to step 20 (checkpoint every 10)")
    tr = Trainer(cfg, opt, TrainerConfig(batch=4, seq=32, steps=20,
                                         ckpt_every=10, ckpt_dir=ckpt,
                                         log_every=10), device=args.device)
    tr.init(seed=0)
    tr.run()

    print("\nphase 2: pod5 misses f=3 heartbeats of t -> declared dead")
    plan = tr.on_member_dead("pod5", alive_pods=7)
    print(f"  resize plan: {plan.old_pods} pods -> {plan.new_pods} "
          f"(mesh {plan.mesh_shape}, reshard={plan.reshard}, "
          f"batch x{plan.batch_scale:.2f})")

    print("\nphase 3: restart on the new mesh; torrent-restore checkpoint")
    tr2 = Trainer(cfg, opt, TrainerConfig(batch=4, seq=32, steps=40,
                                          ckpt_every=10, ckpt_dir=ckpt,
                                          log_every=10), device=args.device)
    tr2.init(seed=0)          # restores step 20, pipeline state included
    assert int(tr2.state["step"]) == 20
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        tree_leaves_with_path(tr.state), tree_leaves_with_path(tr2.state)))
    print(f"  restored state identical: {same}; resuming to step 40")
    hist = tr2.run()
    print(f"  final loss {hist[-1]['loss']:.4f} at step "
          f"{int(tr2.state['step'])}")


if __name__ == "__main__":
    main()
