"""The plain reference of a training step: the loss of the model of
`ops` in float32 (mean next-token NLL plus the router's load-balance
loss), its gradients by autograd, each layer recomputed in the backward
(`torch.utils.checkpoint`) so that it fits, and AdamW written out.
Imports nothing of the program under test."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference import ops


def _layers(m: dict):
    for gi, g in enumerate(m["groups"]):
        for r in range(g["repeat"]):
            for pi, ls in enumerate(g["layers"]):
                yield gi, r, pi, ls


def _slice(tree, r):
    return {k: _slice(v, r) for k, v in tree.items()} \
        if isinstance(tree, dict) else tree[r]


def moe_aux(p: dict, h: torch.Tensor, m: dict) -> torch.Tensor:
    """The load-balance loss of one MoE layer over its input h:
    E * sum_e f_e P_e / k, f_e the share of assignments to expert e and
    P_e its mean router probability (Switch Transformer)."""
    E, k = m["num_experts"], m["experts_per_token"]
    hf = h.reshape(-1, h.shape[-1])
    probs = torch.softmax((hf.double() @ p["router"].double()).float(), -1)
    _, experts = ops.moe_route(hf.detach(), p["router"].detach(), k)
    f = torch.bincount(experts.reshape(-1), minlength=E).float() / hf.shape[0]
    return E * torch.sum(f * probs.mean(0)) / k


def _mid(ls, p, shared, x, m, prec):
    """The residual after the mixer (and the shared attention)."""
    no_mlp = dict(ls, mlp="none")
    return ops.layer(no_mlp, p, shared, x, m, prec)[0]


def loss(m: dict, params: dict, tokens: torch.Tensor, labels: torch.Tensor,
         prec: str = "f32") -> torch.Tensor:
    """Mean token NLL of ``labels`` plus ``router_aux_coef`` times the
    MoE layers' load-balance losses."""
    x = ops.embed(params["embed"]["embedding"], tokens)
    aux = torch.zeros((), device=x.device)
    shared = params.get("shared_attn")
    for gi, r, pi, ls in _layers(m):
        p = _slice(params["decoder"][f"g{gi}"][f"L{pi}"], r)

        def body(x, p=p, ls=ls):
            if ls["mlp"] != "moe":
                return ops.layer(ls, p, shared, x, m, prec)[0], \
                    torch.zeros((), device=x.device)
            mid = _mid(ls, p, shared, x, m, prec)
            h = ops.rms_norm(mid, p["ln_mlp"], m["norm_eps"])
            y, _ = ops.moe(p["moe"], h, m, prec)
            return mid + y, moe_aux(p["moe"], h, m)
        x, a = checkpoint(body, x, use_reentrant=False)
        aux = aux + a
    h = ops.rms_norm(x, params["embed"]["final_norm"], m["norm_eps"])
    nll = 0.0
    for b in range(h.shape[0]):                   # a row at a time
        lg = ops.ein(prec, "sd,dv->sv", h[b], params["embed"]["lm_head"])
        nll = nll + F.cross_entropy(lg, labels[b].long(), reduction="sum")
    return nll / labels.numel() + m.get("router_aux_coef", 0.0) * aux


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
