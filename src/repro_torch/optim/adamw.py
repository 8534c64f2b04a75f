"""AdamW with warmup-cosine schedule, global-norm clipping.

Counterpart of `repro.optim.adamw`, on nested dicts of tensors.  The math
is the reference's, in f32: the moments are f32, the bias corrections
use the step count, and decoupled weight decay applies to matrices only
(``ndim >= 2``).  On a mesh the update is elementwise on each rank's
blocks; only the clipping norm crosses ranks.  `adamw_update` updates the parameters and moments in
place and returns them; a caller that hands the state to another thread
snapshots it first (`checkpoint.store.async_save` does).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.parallel.sharding import (ParamSpec, tree_leaves_with_path,
                                           tree_map_specs)


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then cosine down to
    ``min_lr_ratio * lr``; f32, on the step's device."""
    step = step.float()
    warm = (step + 1.0) / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init_specs(param_specs) -> dict:
    """Optimizer-state spec tree mirroring the parameter spec tree."""
    def zero_like(s: ParamSpec) -> ParamSpec:
        return ParamSpec(s.shape, s.logical, torch.float32, init="zeros")
    return {
        "m": tree_map_specs(zero_like, param_specs),
        "v": tree_map_specs(zero_like, param_specs),
    }


def global_norm(tree, mesh=None, leaf_axes=None) -> torch.Tensor:
    """The L2 norm of every leaf at once.  Under ``mesh`` each leaf is
    this rank's block, cut over ``leaf_axes[path]``: the sums of squares
    of the leaves cut alike are psummed over their axes, so each element
    of the whole tree counts once, a replicated leaf's too."""
    from repro_torch.parallel import collectives as C
    by_axes: dict = {}
    for path, g in tree_leaves_with_path(tree):
        part = torch.sum(torch.square(g.float()))
        axes = leaf_axes[path] if mesh is not None else ()
        by_axes[axes] = by_axes[axes] + part if axes in by_axes else part
    return torch.sqrt(sum(C.psum(v, a, mesh) for a, v in by_axes.items()))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, opt_state, step,
                 mesh=None, leaf_axes=None) -> Tuple[dict, dict, dict]:
    """Returns (new_params, new_opt_state, stats): ``params`` and the
    moments, updated in place.  Under ``mesh`` the trees are this rank's
    blocks and the clipping norm is the whole tree's (`global_norm`)."""
    gnorm = global_norm(grads, mesh, leaf_axes)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                         max=1.0) if cfg.grad_clip > 0
             else torch.ones((), device=gnorm.device))
    lr = lr_schedule(cfg, step)
    t = step.float() + 1.0
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t
    grads_at = dict(tree_leaves_with_path(grads))
    m_at = dict(tree_leaves_with_path(opt_state["m"]))
    v_at = dict(tree_leaves_with_path(opt_state["v"]))
    for path, p in tree_leaves_with_path(params):
        g = grads_at[path].float() * scale
        m, v = m_at[path], v_at[path]
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        pf = p.float()
        # decoupled weight decay on matrices only (ndim >= 2)
        if p.ndim >= 2:
            delta = delta + cfg.weight_decay * pf
        p.copy_(pf - lr * delta)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
