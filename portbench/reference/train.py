"""The plain reference's optimizer: AdamW written out, on flat {path:
tensor} dicts.  The loss whose gradients it takes is the configuration's
reference module's (``loss``; the contract is in `reference/ops.py`), and
`check.reference_steps` drives the two.  Imports nothing of the program
under test and no architecture."""
from __future__ import annotations

import math


def adamw(params: dict, grads: dict, state: dict, step: int, opt: dict
          ) -> None:
    """One AdamW step on flat {path: tensor} dicts, in place: clipping
    by the global norm, linear warm-up then cosine learning rate, bias
    corrections, decoupled weight decay on matrices."""
    gnorm = math.sqrt(sum(float(g.double().square().sum())
                          for g in grads.values()))
    scale = min(1.0, opt["grad_clip"] / max(gnorm, 1e-9)) \
        if opt["grad_clip"] > 0 else 1.0
    warm, total = opt["warmup_steps"], opt["total_steps"]
    if step < warm:
        lr = opt["lr"] * (step + 1) / max(warm, 1)
    else:
        prog = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
        lr = opt["lr"] * (opt["min_lr_ratio"] + (1 - opt["min_lr_ratio"])
                          * 0.5 * (1 + math.cos(math.pi * prog)))
    t = step + 1
    bc1, bc2 = 1 - opt["b1"] ** t, 1 - opt["b2"] ** t
    for path, p in params.items():
        g = grads[path] * scale
        mo, v = state["m"][path], state["v"][path]
        mo.mul_(opt["b1"]).add_((1 - opt["b1"]) * g)
        v.mul_(opt["b2"]).add_((1 - opt["b2"]) * g.square())
        delta = (mo / bc1) / ((v / bc2).sqrt() + opt["eps"])
        if p.ndim >= 2:
            delta = delta + opt["weight_decay"] * p
        p.sub_(lr * delta)
