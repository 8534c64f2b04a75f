"""Mixture-of-experts layer.

Counterpart of `repro.models.moe` (its mesh paths below): top-k softmax
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
The two reads through the slot map, the buffer's and the combine's, carry
their own backward (`_Dispatch`, `_Combine`): a gather through the map's
inverse, under a ``moe.backward`` span.  PyTorch's backward of an index
read is an accumulating `index_put_`, which sorts the indices and adds
each run of equal ones serially; here every empty slot reads the one zero
row and every dropped assignment the one trash row, long runs whose
gradient is thrown away.

Under a mesh with a ``model`` axis (`parallel.sharding.sharding_ctx`)
`moe_block` takes the reference's sharded dispatch (`_moe_block_mesh`):
``a2a`` when the sequence splits over ``model`` (each rank routes its
sequence block into a full-E buffer and an all-to-all brings each rank
its experts' slots, and back), else ``replicated`` (every rank routes
all its batch rows, runs its own experts and a psum combines), with the
capacity of the local token count (dropless to 256 tokens), the aux
statistics averaged across token shards before their product, and the
int8 all-to-all (``cfg.moe_a2a_int8``) with its straight-through
backward, a full-precision all-to-all with the dims swapped.  The
dispatch and combine carry gradients: the all-to-alls' backwards are
all-to-alls (`parallel.collectives`).
"""
from __future__ import annotations

import collections
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import mlp_apply, mlp_specs
from repro_torch.parallel import sharding as shlib
from repro_torch.parallel.sharding import ParamSpec
from repro_torch.spans import RECORDS, recording, span

# the sharded dispatches taken, by strategy ("a2a", "replicated")
DISPATCH: collections.Counter = collections.Counter()


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
    # the slot counter, while a profiler records: the per-expert counts
    # the plan computes anyway, left on their device (no launch, no
    # sync).  A reader reduces the records: kept = sum_e min(counts_e,
    # capacity) of e_count * capacity slots; on one device the dropped
    # assignments are N k - kept
    if recording():
        RECORDS["moe.slots"].append((counts[:e_count], capacity))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(nk, device=flat.device) - starts[e_s]
    keep_s = (pos < capacity) & (e_s < e_count)
    dest_s = torch.where(keep_s, e_s * capacity + pos,
                         torch.full_like(pos, e_count * capacity))
    keep = torch.empty_like(keep_s).scatter_(0, order, keep_s)
    dest = torch.empty_like(dest_s).scatter_(0, order, dest_s)
    return keep, dest


def _padded(rows: torch.Tensor) -> torch.Tensor:
    """rows (R, d) and one zero row after them, at index R."""
    return torch.cat([rows, rows.new_zeros(1, rows.shape[-1])])


def _slot_map(dest: torch.Tensor, slots: int, empty: int,
              value: torch.Tensor) -> torch.Tensor:
    """(slots,): ``value[a]`` in slot ``dest[a]`` of each assignment a,
    ``empty`` where no assignment went.  A slot holds at most one
    assignment; the dropped ones all land in the trash entry past the
    last slot, which is cut off."""
    return torch.full((slots + 1,), empty, dtype=torch.long,
                      device=dest.device).index_copy_(0, dest, value)[:-1]


class _Dispatch(torch.autograd.Function):
    """The buffer's read of the tokens, ``_padded(xf)[src]``.  Backward:
    each token's k slots of the buffer's gradient, gathered through
    ``dest`` (a dropped assignment reads the zero row past the last slot)
    and summed in routing order: no sort, no atomics, deterministic."""

    @staticmethod
    def forward(ctx, xf, src, dest):
        ctx.save_for_backward(dest)
        ctx.tokens = xf.shape[0]
        return _padded(xf)[src]

    @staticmethod
    def backward(ctx, g):
        (dest,) = ctx.saved_tensors
        with span("moe.backward"):
            rows = _padded(g)[dest].view(ctx.tokens, -1, g.shape[-1])
            return rows.sum(dim=1), None, None


class _Combine(torch.autograd.Function):
    """The assignments' read of the expert outputs, ``_padded(y)[dest]``.
    Backward: each slot's gradient row gathered from the assignment that
    filled it (the slot map's inverse of ``dest``); an empty slot reads
    the zero row past the last assignment."""

    @staticmethod
    def forward(ctx, y, dest):
        ctx.save_for_backward(dest)
        ctx.slots = y.shape[0]
        return _padded(y)[dest]

    @staticmethod
    def backward(ctx, g):
        (dest,) = ctx.saved_tensors
        with span("moe.backward"):
            nk = dest.numel()
            inv = _slot_map(dest, ctx.slots, nk,
                            torch.arange(nk, device=dest.device))
            return _padded(g)[inv], None


def _dispatch_buffer(xf, experts, capacity, e_base, e_count, keepers=None):
    """The (e_count, capacity, d) expert buffer of xf's tokens and the
    plan (keep, dest) that combines its outputs back (`_combine`)."""
    N, d = xf.shape
    k = experts.shape[1]
    keep, dest = _dispatch_plan(experts, capacity, e_base, e_count, keepers)
    tok = torch.arange(N, device=xf.device)[:, None].expand(N, k).reshape(-1)
    # slot -> source token; an empty slot reads row N = 0
    src = _slot_map(dest, e_count * capacity, N, tok)
    return (_Dispatch.apply(xf, src, dest).reshape(e_count, capacity, d),
            keep, dest)


def _expert_mlp(buf, wi_g, wi_u, wo):
    """The experts' SwiGLU on their (E, capacity, d) slots."""
    dt = buf.dtype
    h = F.silu(torch.bmm(buf, wi_g.to(dt))) * torch.bmm(buf, wi_u.to(dt))
    return torch.bmm(h, wo.to(dt))


def _combine(y, gates, keep, dest):
    """Each token's k expert outputs (y: (E, capacity, d)), gate-weighted
    and summed in routing order: (N, d)."""
    N, k = gates.shape
    d = y.shape[-1]
    w = (gates.reshape(-1) * keep).to(y.dtype)
    return (_Combine.apply(y.reshape(-1, d), dest) * w[:, None]
            ).reshape(N, k, d).sum(dim=1)


def _dispatch_compute(xf, gates, experts, keepers, wi_g, wi_u, wo, capacity,
                      e_base, e_count):
    """Scatter tokens into an (e_count, capacity, d) buffer, run the
    experts, gather back.  Returns out (N, d) in xf's dtype."""
    with span("moe.dispatch"):
        buf, keep, dest = _dispatch_buffer(xf, experts, capacity, e_base,
                                           e_count, keepers)
    with span("moe.experts"):
        y = _expert_mlp(buf, wi_g, wi_u, wo)
    with span("moe.combine"):
        return _combine(y, gates, keep, dest)


def capacity(cfg: ModelConfig, N: int) -> int:
    """Slots per expert for N tokens: dropless to 512 tokens, else
    ceil(N k / E * capacity_factor)."""
    if N <= 512:
        return N
    return int(math.ceil(N * cfg.experts_per_token / cfg.num_experts
                         * cfg.capacity_factor))


def moe_block(params: dict, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss).  Tiled by four spans:
    ``moe.route`` (router, top-k; the aux statistics), ``moe.dispatch``,
    ``moe.experts`` and ``moe.combine``."""
    mesh = shlib.current_mesh()
    if mesh is not None and "model" in shlib.axis_sizes(mesh):
        return _moe_block_mesh(params, x, cfg, mesh)
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    xf = x.reshape(B * S, d)
    with span("moe.route"):
        gates, experts, probs = _route(xf, params["router"], k)
    out = _dispatch_compute(xf, gates, experts, None, params["wi_gate"],
                            params["wi_up"], params["wo"],
                            capacity(cfg, B * S), 0, E)
    # the aux statistics after the combine: ahead of the dispatch, a
    # checkpoint's recompute launches more kernels for them
    with span("moe.route"):
        aux = _aux_loss(probs, experts, E)
    out = out.reshape(B, S, d)
    if cfg.shared_expert:
        with span("moe.experts"):
            out = out + mlp_apply(params["shared"], x)
    return out, aux


# --------------------------------------------------------------------------- #
# The mesh path: expert parallelism over ``model``
# --------------------------------------------------------------------------- #
def local_capacity(cfg: ModelConfig, N_loc: int) -> int:
    """Slots per expert for a shard's N_loc tokens: dropless to 256
    tokens, else ceil(N_loc k / E * capacity_factor) (the reference's
    sharded rule)."""
    if N_loc <= 256:
        return max(N_loc, 1)
    return max(int(math.ceil(N_loc * cfg.experts_per_token / cfg.num_experts
                             * cfg.capacity_factor)), 1)


class _A2AInt8(torch.autograd.Function):
    """The int8 all-to-all, forward compressed; the backward moves the
    cotangent at full precision with the dims swapped (the reference's
    `_a2a_int8_bwd`)."""

    @staticmethod
    def forward(ctx, x, axes, mesh, split_axis, concat_axis):
        from repro_torch.parallel import collectives as C
        ctx.args = (axes, mesh, concat_axis, split_axis)
        xf = x.float()
        amax = xf.abs().amax(dim=-1, keepdim=True)
        scale = torch.clamp(amax, min=1e-12) / 127.0
        q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
        q = C.all_to_all(q, axes, mesh, split_axis, concat_axis)
        s = C.all_to_all(scale, axes, mesh, split_axis, concat_axis)
        return (q.float() * s).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.parallel import collectives as C
        return C.all_to_all(g, *ctx.args), None, None, None, None


def a2a_int8(x: torch.Tensor, axes, mesh, split_axis: int,
             concat_axis: int) -> torch.Tensor:
    """all_to_all with an int8 payload and a per-row f32 scale (max|x| of
    the last dim / 127), the reference's `_a2a_int8`: a straight-through
    gradient, the backward an exact all-to-all of the cotangent."""
    return _A2AInt8.apply(x, axes, mesh, split_axis, concat_axis)


def _moe_block_mesh(params: dict, x: torch.Tensor, cfg: ModelConfig, mesh
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's sharded `moe_block` on this rank: ``x`` is its
    block of the residual stream, the expert weights its ``E / mp``
    experts (``experts`` over ``model``)."""
    from repro_torch.models.layers import residual_spec
    from repro_torch.parallel import collectives as C
    sizes = shlib.axis_sizes(mesh)
    d = x.shape[-1]
    S = (shlib.current_dim("seq") if shlib.current_rules().mesh_axes(
        "seq_act") else x.shape[1])
    Bg = shlib.current_dim("batch")
    E, k = cfg.num_experts, cfg.experts_per_token
    mp = sizes["model"]
    if E % mp:
        raise ValueError(f"{E} experts do not split over model = {mp}")
    E_loc = E // mp
    data_axes = tuple(a for a in ("pod", "data") if a in sizes)
    dp = shlib._axis_size(mesh, data_axes)
    batch_shardable = Bg % dp == 0
    strategy = "a2a" if S % mp == 0 and S >= mp else "replicated"
    DISPATCH[strategy] += 1
    # the reference's token layout for the dispatch, from the residual's
    res = residual_spec()
    b_in = shlib._entry(data_axes) if batch_shardable else None
    s_in = "model" if strategy == "a2a" else None
    xl = C.relayout(x, res, (b_in, s_in, None), mesh)
    xf = xl.reshape(-1, d)
    N_loc = xf.shape[0]
    cap = local_capacity(cfg, N_loc)
    with span("moe.route"):
        gates, experts, probs = _route(xf, params["router"], k)
        # the aux statistics, averaged across the token shards before
        # their product, so the sharded aux equals the global batch's
        f_loc, p_loc = _aux_stats(probs, experts, E)
        stat_axes = (data_axes + ("model",) if strategy == "a2a"
                     else data_axes)
        aux = E * torch.sum(C.pmean(f_loc, stat_axes, mesh)
                            * C.pmean(p_loc, stat_axes, mesh)) / k
    wi_g, wi_u, wo = params["wi_gate"], params["wi_up"], params["wo"]
    if strategy == "a2a":
        # (E, cap, d) -> each rank its E_loc experts' slots of every rank
        a2a = a2a_int8 if cfg.moe_a2a_int8 else C.all_to_all
        with span("moe.dispatch"):
            buf, keep, dest = _dispatch_buffer(xf, experts, cap, 0, E)
            buf = a2a(buf, "model", mesh, 0, 1)
        with span("moe.experts"):
            y = _expert_mlp(buf, wi_g, wi_u, wo)
        with span("moe.combine"):
            out = _combine(a2a(y, "model", mesh, 1, 0), gates, keep, dest)
    else:
        e_base = C.axis_index("model", mesh) * E_loc
        out = _dispatch_compute(xf, gates, experts, None, wi_g, wi_u, wo, cap,
                                e_base, E_loc)
        with span("moe.combine"):
            out = C.psum(out, "model", mesh)
    out = C.relayout(out.reshape(xl.shape), (b_in, s_in, None), res, mesh)
    if cfg.shared_expert:
        with span("moe.experts"):
            out = out + mlp_apply(params["shared"], x, d_ff=cfg.moe_d_ff)
    return out, aux
