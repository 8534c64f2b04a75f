"""End-to-end LM training driver on the PyTorch port.

The counterpart of `examples/train_lm.py` on `repro_torch`.  Default: a
~20M-param granite-family model for 100 steps; `--size 100m --steps 300`
gives the ~100M x few-hundred-step run; `--arch` selects any assigned
architecture family.  Runs on the card unless ``--device cpu`` is given;
checkpoints go to a fresh temporary directory unless ``--ckpt-dir`` names
one.

  PYTHONPATH=src python examples/port_train_lm.py [--size 20m|100m]
      [--steps N] [--device cuda|cpu]
"""
import argparse
import tempfile

from repro_torch.configs.base import GroupSpec, LayerSpec, get_config
from repro_torch.models.model import count_params
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.training.trainer import Trainer, TrainerConfig

SIZES = {
    # name: (layers, d_model, heads, kv, head_dim, d_ff, vocab)
    "tiny": (2, 64, 4, 2, 16, 128, 512),
    "20m": (4, 256, 8, 4, 32, 1024, 8192),
    "100m": (8, 640, 10, 5, 64, 2560, 32768),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--size", default="20m", choices=list(SIZES))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_train_lm_")

    L, d, h, kv, hd, ff, v = SIZES[args.size]
    cfg = get_config(args.arch).replace(
        d_model=d, num_heads=h, num_kv_heads=kv, head_dim=hd, d_ff=ff,
        vocab_size=v, groups=(GroupSpec((LayerSpec(),), L),),
        attn_chunk_q=128, attn_chunk_kv=128, remat="none", loss_chunk=0)
    print(f"{args.arch} @ {args.size}: {count_params(cfg) / 1e6:.1f}M params")

    tc = TrainerConfig(batch=args.batch, seq=args.seq, steps=args.steps,
                       ckpt_every=max(args.steps // 4, 1),
                       ckpt_dir=ckpt_dir, log_every=10, sdc_every=50)
    tr = Trainer(cfg, AdamWConfig(lr=1e-3, warmup_steps=20,
                                  total_steps=args.steps), tc,
                 device=args.device)
    tr.init()
    hist = tr.run()
    losses = [h["loss"] for h in hist]
    print(f"\nloss: first5={sum(losses[:5]) / 5:.3f} "
          f"last5={sum(losses[-5:]) / 5:.3f}")
    print(f"checkpoints at {ckpt_dir}: {tr.store.steps()}")
    print(f"SDC sentinel reports: {len(tr.sdc.reports)}")


if __name__ == "__main__":
    main()
