"""Mixture-of-experts layer, single device.

Counterpart of `repro.models.moe` without its mesh paths: top-k softmax
routing with renormalised gates, the load-balance auxiliary loss, and the
capacity-bounded dispatch into an ``(E, capacity, d)`` buffer, three
batched expert products and the gate-weighted combine.  Capacity overflow
drops assignments (the residual keeps those tokens); a batch of at most 512
tokens gets dropless capacity, as in the reference.

What is kept equal to the reference, and how:

  * the router product never runs in TF32, whatever the process's
    setting: it is taken in f64 and rounded to f32, which needs no global
    flag (a TF32 product moves routing; the f64 one differs from an f32
    product by the f32 rounding of the sum, as two f32 orders do);
  * top-k takes the k largest probabilities in a stable descending sort,
    so ties go to the lower expert index as `lax.top_k` gives them, and
    the dispatch order is a stable sort by expert, as the reference's
    `argsort(stable=True)`;
  * per-expert counts are a `scatter_add_` of fixed length E + 1, so the
    layer never waits on the device (no `bincount`, `nonzero` or
    data-dependent shape), a decode step included.

The buffer is a gather: each of its ``E * capacity`` slots names the token
that fills it, or a zero row.  The combine is deterministic: each token's k
expert outputs are gathered in routing order into ``(N, k, d)`` and summed
over k, with no atomics (a CUDA `index_add_` would add a token's k
contributions in an order that changes from run to run).  The reference
adds them in expert order, so sums differ from it in the last bits only.

The sharded dispatch (a2a, replicated, and the int8 a2a), which the
reference takes under an ambient mesh, comes with the meshes slice (ROADMAP
queue 1, item 5): the port has no mesh yet, so `moe_block` keeps the
reference's signature and always runs on one device.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import mlp_apply, mlp_specs
from repro_torch.parallel.sharding import ParamSpec

def moe_specs(cfg: ModelConfig) -> dict:
    E, dff, d = cfg.num_experts, cfg.moe_d_ff, cfg.d_model
    specs = {
        "router": ParamSpec((d, E), ("embed", None), scale=1.0),
        "wi_gate": ParamSpec((E, d, dff), ("experts", "embed", None)),
        "wi_up": ParamSpec((E, d, dff), ("experts", "embed", None)),
        "wo": ParamSpec((E, dff, d), ("experts", None, "embed")),
    }
    if cfg.shared_expert:
        specs["shared"] = mlp_specs(cfg, d_ff=cfg.moe_d_ff)
    return specs


def _route(xf: torch.Tensor, router_w: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xf: (N, d) -> (gates (N, k) f32, experts (N, k) int64, probs (N, E)
    f32)."""
    logits = (xf.double() @ router_w.double()).float()
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = gates[:, :k], experts[:, :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, experts, probs


def _expert_counts(experts: torch.Tensor, length: int,
                   dtype=torch.float32) -> torch.Tensor:
    """Assignments per expert id, a vector of fixed ``length``."""
    flat = experts.reshape(-1)
    return torch.zeros(length, dtype=dtype, device=flat.device
                       ).scatter_add_(0, flat, torch.ones_like(flat,
                                                               dtype=dtype))


def _aux_stats(probs: torch.Tensor, experts: torch.Tensor, E: int):
    """(f_e, P_e): the fraction of assignments routed to each expert and
    its mean router probability."""
    f = _expert_counts(experts, E) / experts.shape[0]
    return f, probs.mean(dim=0)


def _aux_loss(probs: torch.Tensor, experts: torch.Tensor, E: int
              ) -> torch.Tensor:
    """Load-balance loss: E * sum_e f_e * P_e / k (Switch Transformer)."""
    f, p = _aux_stats(probs, experts, E)
    return E * torch.sum(f * p) / experts.shape[1]


def _dispatch_plan(experts: torch.Tensor, capacity: int, e_base: int,
                   e_count: int, keepers: Optional[torch.Tensor] = None):
    """The reference's slot assignment, in routing order.  experts (N, k);
    returns (keep (N*k,) bool, dest (N*k,) int64): assignment j of token n
    is entry n*k + j; a kept one goes to buffer row ``dest`` = local expert
    * capacity + its rank among that expert's assignments (stable by
    token), a dropped one to the trash row ``e_count * capacity``."""
    flat = experts.reshape(-1).long()
    nk = flat.numel()
    local = (flat >= e_base) & (flat < e_base + e_count)
    if keepers is not None:
        local &= keepers.reshape(-1)
    e_local = torch.where(local, flat - e_base, torch.full_like(flat,
                                                                e_count))
    e_s, order = torch.sort(e_local, stable=True)
    counts = _expert_counts(e_s, e_count + 1, torch.long)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(nk, device=flat.device) - starts[e_s]
    keep_s = (pos < capacity) & (e_s < e_count)
    dest_s = torch.where(keep_s, e_s * capacity + pos,
                         torch.full_like(pos, e_count * capacity))
    keep = torch.empty_like(keep_s).scatter_(0, order, keep_s)
    dest = torch.empty_like(dest_s).scatter_(0, order, dest_s)
    return keep, dest


def _dispatch_compute(xf, gates, experts, keepers, wi_g, wi_u, wo, capacity,
                      e_base, e_count):
    """Scatter tokens into an (e_count, capacity, d) buffer, run the
    experts, gather back.  Returns out (N, d) in xf's dtype."""
    N, d = xf.shape
    k = gates.shape[1]
    keep, dest = _dispatch_plan(experts, capacity, e_base, e_count, keepers)
    tok = torch.arange(N, device=xf.device)[:, None].expand(N, k).reshape(-1)
    # slot -> source token; empty slots (and the trash row) read row N = 0
    src = torch.full((e_count * capacity + 1,), N, dtype=torch.long,
                     device=xf.device).index_copy_(0, dest, tok)
    xpad = torch.cat([xf, xf.new_zeros(1, d)])
    buf = xpad[src[:-1]].reshape(e_count, capacity, d)
    dt = buf.dtype
    h_g = torch.bmm(buf, wi_g.to(dt))
    h_u = torch.bmm(buf, wi_u.to(dt))
    y = torch.bmm(F.silu(h_g) * h_u, wo.to(dt))
    y_flat = torch.cat([y.reshape(e_count * capacity, d), y.new_zeros(1, d)])
    w = (gates.reshape(-1) * keep).to(dt)
    return (y_flat[dest] * w[:, None]).reshape(N, k, d).sum(dim=1)


def capacity(cfg: ModelConfig, N: int) -> int:
    """Slots per expert for N tokens: dropless to 512 tokens, else
    ceil(N k / E * capacity_factor)."""
    if N <= 512:
        return N
    return int(math.ceil(N * cfg.experts_per_token / cfg.num_experts
                         * cfg.capacity_factor))


def moe_block(params: dict, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    xf = x.reshape(B * S, d)
    gates, experts, probs = _route(xf, params["router"], k)
    out = _dispatch_compute(xf, gates, experts, None, params["wi_gate"],
                            params["wi_up"], params["wo"],
                            capacity(cfg, B * S), 0, E)
    aux = _aux_loss(probs, experts, E)
    out = out.reshape(B, S, d)
    if cfg.shared_expert:
        out = out + mlp_apply(params["shared"], x)
    return out, aux
