"""Shared neural building blocks: norms, RoPE (incl. M-RoPE), embeddings,
the LM head and the SwiGLU MLP.

Counterpart of `repro.models.layers`, with its losses (the
sequence-chunked `lm_head_loss` and `cross_entropy`).  Under a mesh
(`parallel.sharding.sharding_ctx`) the blocks compute on local shards:
the embedding lookup over vocab shards (a masked local take and a
psum), the LM head's logits over vocab shards with the greedy token
combined across them (`greedy_tokens`), the loss over vocab shards (the
log-sum-exp and the gold logit psummed over them, the token sums over
the batch axes), and the MLP column-parallel in, row-parallel out, with
`col_parallel_mlp_in` / `row_parallel_proj` (the sequence all-gather
and the psum_scatter) under ``cfg.tp_sp``.

The residual stream between blocks lies in the rules' layout of
``("batch", "seq_act", None)`` (`residual_spec`): under `DEFAULT_RULES`
its sequence is split over ``model``.  A block takes it whole-sequence
(`block_input`, an all-gather over the sequence where it is split) and
gives its partial sums back (`reduce_to_residual`, a psum_scatter over
the sequence where the residual is split over the summed axes, else a
psum and a slice).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel import sharding as shlib
from repro_torch.parallel.sharding import ParamSpec, act_spec


# --------------------------------------------------------------------------- #
# Norms
# --------------------------------------------------------------------------- #
def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm with the variance reduced in f32 and the scale applied in
    x's dtype; gamma is stored as (gamma - 1), so zeros are the identity."""
    dt = x.dtype
    var = torch.mean(x.square(), dim=-1, keepdim=True, dtype=torch.float32)
    scale = torch.rsqrt(var + eps).to(dt)
    return x * scale * (1.0 + gamma.to(dt))


def norm_spec(dim: int) -> ParamSpec:
    # stored as (gamma - 1) so zeros-init == identity
    return ParamSpec((dim,), (None,), init="zeros")


# --------------------------------------------------------------------------- #
# RoPE
# --------------------------------------------------------------------------- #
def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def _rotate(x: torch.Tensor, cos: torch.Tensor,
            sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], -1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)           # (half,)
    angles = positions[..., None].float() * freqs              # (..., S, half)
    return _rotate(x, torch.cos(angles)[..., None, :],
                   torch.sin(angles)[..., None, :])


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, ...]) -> torch.Tensor:
    """Multimodal 3D RoPE (Qwen2-VL).  x: (B, S, H, D); positions:
    (3, B, S) with (t, h, w) indices; section k of the D/2 frequencies
    rotates by positions[k]."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {sections} must sum to {half}")
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs               # (3,B,S,half)
    parts, start = [], 0
    for k, sec in enumerate(sections):
        parts.append(angles[k, ..., start:start + sec])
        start += sec
    ang = torch.cat(parts, dim=-1)                              # (B,S,half)
    return _rotate(x, torch.cos(ang)[..., None, :],
                   torch.sin(ang)[..., None, :])


# --------------------------------------------------------------------------- #
# Embedding / head
# --------------------------------------------------------------------------- #
def embed_specs(cfg: ModelConfig) -> dict:
    # fsdp_dim=-2 opts the embedding out of FSDP: the lookup runs over the
    # vocab(model) shards and the d_model dim must stay whole per shard
    d = {"embedding": ParamSpec((cfg.vocab_size, cfg.d_model),
                                ("vocab", "embed"), init="embed",
                                scale=0.02, fsdp_dim=-2)}
    if not cfg.tie_embeddings:
        d["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                 ("embed", "vocab"), scale=1.0)
    d["final_norm"] = norm_spec(cfg.d_model)
    return d


def vocab_axes(cfg: ModelConfig) -> Tuple[str, ...]:
    """The mesh axes the vocab dim of the embedding and head shard over
    (none without a mesh)."""
    mesh = shlib.current_mesh()
    if mesh is None:
        return ()
    return shlib._fit_axes(mesh, cfg.vocab_size,
                           shlib.current_rules().mesh_axes("vocab"))


def residual_spec():
    """The residual stream's layout under the current mesh: the batch
    over its axes, the sequence over ``seq_act``'s where the global
    sequence (``sharding_ctx``'s ``seq``) divides them."""
    B = shlib.current_dim("batch")
    S = (shlib.current_dim("seq") if shlib.current_rules().mesh_axes(
        "seq_act") else 1)
    return act_spec((B, S, 1), "batch", "seq_act", None)


def _rows_spec():
    return (act_spec((shlib.current_dim("batch"),), "batch")[0], None, None)


def block_input(x: torch.Tensor) -> torch.Tensor:
    """The residual stream's block ``x`` as this rank's batch rows, whole
    sequences (an all-gather over the sequence where ``seq_act`` splits
    it; its backward reduce-scatters).  The identity without a mesh."""
    mesh = shlib.current_mesh()
    if mesh is None:
        return x
    from repro_torch.parallel.collectives import relayout
    return relayout(x, residual_spec(), _rows_spec(), mesh)


def to_residual(y: torch.Tensor, src=None) -> torch.Tensor:
    """A block's output (B, S, d), this rank's block under ``src`` (by
    default the batch rows, whole sequences), in the residual stream's
    layout (`residual_spec`).  The identity without a mesh."""
    mesh = shlib.current_mesh()
    if mesh is None:
        return y
    from repro_torch.parallel.collectives import relayout
    return relayout(y, src or _rows_spec(), residual_spec(), mesh)


def reduce_to_residual(y: torch.Tensor, axes) -> torch.Tensor:
    """The sum over ``axes`` of partial products ``y`` (this rank's batch
    rows, whole sequences) in the residual stream's layout: one
    psum_scatter over the sequence where the residual splits it over
    exactly ``axes``, else a psum and `to_residual`."""
    mesh = shlib.current_mesh()
    if mesh is None:
        return y
    from repro_torch.parallel import collectives as C
    axes = tuple(axes)
    res = residual_spec()
    if axes and shlib.entry_axes(res[1]) == axes:
        return C.psum_scatter(y, axes, mesh, scatter_dimension=1)
    return to_residual(C.psum(y, axes, mesh))


def embed_tokens(params: dict, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Token lookup.  Under a mesh ``tokens`` are this rank's batch rows
    and the embedding its vocab shard: each shard takes the ids that fall
    in its range (the others read row 0 and are zeroed) and a psum over
    the vocab axes combines them, exactly."""
    emb = params["embedding"]
    vax = vocab_axes(cfg)
    if not vax:
        return to_residual(F.embedding(tokens.long(), emb).to(cfg.act_dtype))
    from repro_torch.parallel import collectives as C
    mesh = shlib.current_mesh()
    V_loc = emb.shape[0]
    loc = tokens.long() - C.axis_index(vax, mesh) * V_loc
    ok = (loc >= 0) & (loc < V_loc)
    g = F.embedding(loc.clamp(0, V_loc - 1), emb).to(cfg.act_dtype)
    g = g * ok[..., None].to(g.dtype)
    return reduce_to_residual(g, vax)


def lm_logits(params: dict, x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """Logits (B, S, V); under a mesh this rank's vocab block of them,
    (B_loc, S, V_loc)."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return torch.einsum("bsd,dv->bsv", x, _head_weight(params, cfg))


def greedy_tokens(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The argmax over the last dim as int32.  Under a mesh ``logits`` is
    a vocab block: each shard's max and first argmax are gathered, and
    the token is the largest value's, ties to the lowest global index,
    as `jnp.argmax` breaks them."""
    vax = vocab_axes(cfg)
    if not vax:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    from repro_torch.parallel import collectives as C
    mesh = shlib.current_mesh()
    V_loc = logits.shape[-1]
    m, a = torch.max(logits.float(), dim=-1)
    a = a + C.axis_index(vax, mesh) * V_loc
    ms = C.all_gather(m[..., None], vax, mesh, axis=-1)
    gs = C.all_gather(a[..., None], vax, mesh, axis=-1)
    best = ms.max(dim=-1, keepdim=True).values
    cand = torch.where(ms == best, gs, torch.full_like(gs, 2 ** 62))
    return cand.min(dim=-1).values.to(torch.int32)


def gather_logits(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """A vocab block of logits as the whole vocab (all ranks)."""
    vax = vocab_axes(cfg)
    if not vax:
        return logits
    from repro_torch.parallel import collectives as C
    return C.all_gather(logits, vax, shlib.current_mesh(), axis=-1)


def _head_weight(params: dict, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings and "lm_head" not in params:
        return params["embedding"].to(cfg.act_dtype).T
    return params["lm_head"].to(cfg.act_dtype)


def _chunk_nll(xs: torch.Tensor, w: torch.Tensor, lbl: torch.Tensor,
               mk: Optional[torch.Tensor], vax, mesh
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the chunk's token NLL, its token count), both f32.  ``w``
    is this rank's vocab block: the log-sum-exp's shift is a pmax, its
    sum and the gold logit (taken by the shard that holds it) psums over
    ``vax`` (no vocab axes: the identity, and ``w`` is the whole head)."""
    from repro_torch.parallel import collectives as C
    logits = torch.einsum("bsd,dv->bsv", xs, w).float()
    V_loc = logits.shape[-1]
    m = C.pmax(logits.amax(dim=-1), vax, mesh)
    se = C.psum(torch.exp(logits - m[..., None]).sum(dim=-1), vax, mesh)
    loc = lbl.long() - C.axis_index(vax, mesh) * V_loc
    ok = (loc >= 0) & (loc < V_loc)
    gold = torch.gather(logits, -1, loc.clamp(0, V_loc - 1)[..., None]
                        )[..., 0] * ok
    nll = m + torch.log(se) - C.psum(gold, vax, mesh)
    if mk is not None:
        mkf = mk.float()
        return torch.sum(nll * mkf), torch.sum(mkf)
    return torch.sum(nll), torch.tensor(float(nll.numel()),
                                        device=nll.device)


def lm_head_loss(params: dict, x: torch.Tensor, labels: torch.Tensor,
                 cfg: ModelConfig,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sequence-chunked softmax cross-entropy.

    Chunks of ``cfg.loss_chunk`` positions, each under activation
    checkpointing, keep the live set to one chunk's (B, c, V) logits
    instead of the whole sequence's.  The reference's chunk rule is
    kept: when c does not divide S, c becomes S // (S // c) and the
    positions past n * c drop out of the mean, as there.  Under a mesh
    ``x`` is this rank's rows and the head its vocab block; the chunks'
    NLL sums and token counts are summed over the batch axes, so every
    rank holds the global batch's mean."""
    from repro_torch.parallel import collectives as C
    mesh = shlib.current_mesh()
    vax = vocab_axes(cfg)
    x = rms_norm(block_input(x), params["final_norm"], cfg.norm_eps)
    w = _head_weight(params, cfg)
    S = x.shape[1]
    c = cfg.loss_chunk
    if not c or S <= c:
        c = S
    elif S % c:
        c = S // (S // c)  # keep chunks equal; S is a power of two in practice
    n = S // c
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        sl = slice(i * c, (i + 1) * c)
        args = (x[:, sl], w, labels[:, sl],
                None if mask is None else mask[:, sl], vax, mesh)
        t, k = (checkpoint(_chunk_nll, *args, use_reentrant=False) if n > 1
                else _chunk_nll(*args))
        tot = tot + t
        cnt = cnt + k
    bax = shlib.entry_axes(act_spec(
        (shlib.current_dim("batch", x.shape[0]),), "batch")[0])
    tot, cnt = C.psum(tot, bax, mesh), C.psum(cnt, bax, mesh)
    return tot / torch.clamp(cnt, min=1.0)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token NLL; logits (B, S, V), labels (B, S) int32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


# --------------------------------------------------------------------------- #
# Dense MLP (SwiGLU)
# --------------------------------------------------------------------------- #
def mlp_specs(cfg: ModelConfig, d_ff: Optional[int] = None) -> dict:
    dff = d_ff or cfg.d_ff
    return {
        "wi_gate": ParamSpec((cfg.d_model, dff), ("embed", "mlp")),
        "wi_up": ParamSpec((cfg.d_model, dff), ("embed", "mlp")),
        "wo": ParamSpec((dff, cfg.d_model), ("mlp", "embed")),
    }


def _tp_sp_ok(S: int, cols: int):
    """The mesh where the reference's shard_map projections of ``tp_sp``
    apply: a model axis of more than one rank dividing the sequence and
    the sharded columns, and the batch dividing the data axes; else
    None."""
    mesh = shlib.current_mesh()
    sizes = shlib.axis_sizes(mesh)
    if sizes.get("model", 1) == 1:
        return None
    if S % sizes["model"] or cols % sizes["model"]:
        return None
    data_axes = tuple(a for a in ("pod", "data") if a in sizes)
    if shlib.current_dim("batch") % shlib._axis_size(mesh, data_axes):
        return None
    return mesh


def row_parallel_proj(h: torch.Tensor, w: torch.Tensor, eq: str,
                      cols: int) -> Optional[torch.Tensor]:
    """y = einsum(eq, h, w) with the contraction dim model-sharded
    (``cols`` wide, globally), emitting a psum_scatter over the sequence
    instead of an all-reduce: the result is sequence-sharded over
    ``model``, (B_loc, S / mp, d).  None where the shapes do not divide
    the mesh (the caller takes the einsum and psum)."""
    mesh = _tp_sp_ok(h.shape[1], cols)
    if mesh is None:
        return None
    from repro_torch.parallel import collectives as C
    return C.psum_scatter(torch.einsum(eq, h, w), "model", mesh,
                          scatter_dimension=1)


def col_parallel_mlp_in(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                        dff: int):
    """Column-parallel wi_gate / wi_up with the sequence all-gather inside:
    ``x`` (B_loc, S, d) whole is cut to its sequence block over ``model``
    and gathered back, one gather feeding both products.  Returns None
    where the shapes do not divide the mesh."""
    mesh = _tp_sp_ok(x.shape[1], dff)
    if mesh is None:
        return None
    from repro_torch.parallel import collectives as C
    xg = C.all_gather(C.local_chunk(x, "model", mesh, 1), "model", mesh,
                      axis=1)
    return (torch.einsum("bsd,df->bsf", xg, wg),
            torch.einsum("bsd,df->bsf", xg, wu))


def mlp_apply(params: dict, x: torch.Tensor, tp_sp: bool = False,
              d_ff: Optional[int] = None) -> torch.Tensor:
    """SwiGLU MLP.  Under a mesh ``x`` is the residual stream's local
    block, the in-projections are column blocks (``mlp`` axes, of the
    global width ``d_ff``, which a mesh needs) and ``wo`` a row block:
    the partial products are summed over the ``mlp`` axes (or
    psum_scattered over the sequence under ``tp_sp``) and the result is
    in the residual stream's layout."""
    dt = x.dtype
    mesh = shlib.current_mesh()
    if mesh is not None and d_ff is None:
        raise ValueError("mlp_apply under a mesh needs the global d_ff")
    x = block_input(x)
    dff = d_ff or params["wo"].shape[0]
    max_ = shlib._fit_axes(mesh, dff, shlib.current_rules().mesh_axes("mlp"))
    pair = (col_parallel_mlp_in(x, params["wi_gate"].to(dt),
                                params["wi_up"].to(dt), dff)
            if tp_sp else None)
    if pair is not None:
        gate, up = pair
    else:
        gate = torch.einsum("bsd,df->bsf", x, params["wi_gate"].to(dt))
        up = torch.einsum("bsd,df->bsf", x, params["wi_up"].to(dt))
    h = F.silu(gate) * up
    if tp_sp:
        out = row_parallel_proj(h, params["wo"].to(dt), "bsf,fd->bsd", dff)
        if out is not None:
            return to_residual(out, (act_spec(
                (shlib.current_dim("batch"),), "batch")[0], "model", None))
    out = torch.einsum("bsf,fd->bsd", h, params["wo"].to(dt))
    return reduce_to_residual(out, max_)


# --------------------------------------------------------------------------- #
# The Zamba2 shared block's MLP: gated, with a per-application adapter
# --------------------------------------------------------------------------- #
def adapter_specs(cfg: ModelConfig) -> dict:
    """A rank-``shared_adapter_rank`` adapter of the gate and up
    projections: ``a`` (d_model, r), then ``gate`` / ``up`` (r, d_ff)."""
    r, dff = cfg.shared_adapter_rank, cfg.d_ff
    return {"a": ParamSpec((cfg.d_model, r), ("embed", None)),
            "gate": ParamSpec((r, dff), (None, "mlp")),
            "up": ParamSpec((r, dff), (None, "mlp"))}


def adapted_mlp(params: dict, adapter: dict, x: torch.Tensor
                ) -> torch.Tensor:
    """GELU(x Wg + (x A) Ag) * (x Wu + (x A) Au), then Wo (exact-erf GELU),
    on one device: the shared block's MLP with its application's
    adapter."""
    dt = x.dtype
    xa = torch.einsum("bsd,dr->bsr", x, adapter["a"].to(dt))
    gate = torch.einsum("bsd,df->bsf", x, params["wi_gate"].to(dt)) + \
        torch.einsum("bsr,rf->bsf", xa, adapter["gate"].to(dt))
    up = torch.einsum("bsd,df->bsf", x, params["wi_up"].to(dt)) + \
        torch.einsum("bsr,rf->bsf", xa, adapter["up"].to(dt))
    return torch.einsum("bsf,fd->bsd", F.gelu(gate) * up,
                        params["wo"].to(dt))
