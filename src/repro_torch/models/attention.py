"""Attention: GQA projections + three execution strategies.

Counterpart of `repro.models.attention`:

  * ``full``   — materialised scores with mask;
  * ``brick``  — blocked online-softmax attention over the (q-chunk,
                 kv-chunk) bricks alive under the causal/sliding-window mask
                 (`kernels.flash_attention.ops.brick_fwd`);
  * ``flash``  — `kernels.flash_attention.ops.flash_attention`: the CUDA
                 kernel with ``cfg.use_pallas``, the brick scan otherwise;
  * ``decode`` — single-token attention against a KV cache, with per-slot
                 positions and the ring buffer of sliding-window caches.

Cross attention (encoder-decoder) projects the encoder's output to k/v
once (`encode_cross_kv`) and attends to it without a mask
(`cross_attention_block`); under a mesh on this rank's heads, as the
self-attention block does, and in decode from the cross caches in the
rules' layout (`cross_cache_spec`): a flash-decode over the cache's
sequence blocks where the rules split its sequence.

Under a mesh (`parallel.sharding.sharding_ctx`) `attention_block` runs
on this rank's heads: the projections on its column
blocks, `flash_fwd` on its local heads in prefill (with the kv heads
those heads read, where the kv heads replicate: 4 kv heads over an
8-way ``model`` axis), the reference's ``pad_attn_heads`` and
``_q_col_parallel``, a row-parallel ``wo`` summed over ``model``, and
caches in the rules' layout: a prefill writes a sequence-sharded cache
through an all-to-all from heads to sequence, and decode runs a local
flash-decode on each sequence block, combined with pmax / psum
(`decode_attention`).

Caches are updated in place: the prefill and decode writes go into the
cache tensors the caller passed (the reference returns new arrays), which
saves a copy of every cache per step.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import brick_fwd
from repro_torch.models.layers import (apply_mrope, apply_rope, norm_spec,
                                       rms_norm)
from repro_torch.parallel import sharding as shlib
from repro_torch.parallel.sharding import ParamSpec, act_spec, entry_axes
from repro_torch.spans import spanned

NEG_INF = -1e30


# --------------------------------------------------------------------------- #
# Parameter specs
# --------------------------------------------------------------------------- #
def attn_specs(cfg: ModelConfig, heads: Optional[int] = None,
               kv_heads: Optional[int] = None, cross: bool = False,
               d_in: Optional[int] = None) -> dict:
    """The projections' specs; ``d_in`` is the input's width where it is
    not d_model (the Zamba2 block's concatenation), the output's is."""
    h = heads or cfg.num_heads
    kh = kv_heads or cfg.num_kv_heads
    d = cfg.head_dim
    di = d_in or cfg.d_model
    specs = {
        "wq": ParamSpec((di, h, d), ("embed", "heads", None)),
        "wk": ParamSpec((di, kh, d), ("embed", "kv_heads", None)),
        "wv": ParamSpec((di, kh, d), ("embed", "kv_heads", None)),
        "wo": ParamSpec((h, d, cfg.d_model), ("heads", None, "embed")),
    }
    if cfg.qk_norm and not cross:
        specs["q_norm"] = norm_spec(d)
        specs["k_norm"] = norm_spec(d)
    return specs


def cross_attn_specs(cfg: ModelConfig) -> dict:
    return attn_specs(cfg, cross=True)


def _scaled(scores: torch.Tensor, D: int, scale: Optional[float]
            ) -> torch.Tensor:
    """The scores times ``scale``; divided by sqrt(D) where it is None."""
    return scores / math.sqrt(D) if scale is None else scores * scale


def _softcap(scores: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0.0:
        return cap * torch.tanh(scores / cap)
    return scores


# --------------------------------------------------------------------------- #
# full-scores attention
# --------------------------------------------------------------------------- #
def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int = 0,
                   softcap: float = 0.0, scale: Optional[float] = None
                   ) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D).  Returns (B, Sq, Hq, D).
    The scores are scaled by ``scale`` (None: 1/sqrt(D))."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    q5 = q.reshape(B, Sq, Hkv, G, D)
    scores = _scaled(torch.einsum("bqkgd,bskd->bkgqs", q5, k), D, scale)
    scores = _softcap(scores, softcap).float()
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    scores = torch.where(mask, scores,
                         torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(B, Sq, Hq, D)


# --------------------------------------------------------------------------- #
# brick-scan attention (flop-exact flash, torch)
# --------------------------------------------------------------------------- #
def brick_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    cq: int = 1024, ck: int = 2048,
                    softcap: float = 0.0, scale: Optional[float] = None
                    ) -> torch.Tensor:
    """Blocked online-softmax attention over the needed bricks only."""
    out, _ = brick_fwd(q, k, v, causal, window, cq, ck, softcap=softcap,
                       scale=scale)
    return out


# --------------------------------------------------------------------------- #
# decode attention
# --------------------------------------------------------------------------- #
def _decode_attn_local(q, k, v, kpos, t, window, softcap, scale=None):
    """Attention of one token per sequence over its cache -> (o, m, l)
    un-normalised.  kpos: (B, Sc) positions of the cache slots (< 0 marks
    ring slots not yet written); t: (B,) each sequence's position."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    q5 = q.reshape(B, Sq, Hkv, G, D)
    s = _scaled(torch.einsum("bqkgd,bskd->bqkgs", q5, k), D, scale)
    s = _softcap(s, softcap).float()
    mask = (kpos <= t[:, None]) & (kpos >= 0)
    if window:
        mask &= kpos > (t[:, None] - window)
    s = torch.where(mask[:, None, None, None, :], s,
                    torch.full((), NEG_INF, device=q.device))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bqkgs,bskd->bqkgd", p.to(q.dtype), v).float()
    return o, m, l


def per_seq(index, B: int, device) -> torch.Tensor:
    """A scalar or (B,) position as a (B,) int64 tensor."""
    t = torch.as_tensor(index, device=device)
    return torch.broadcast_to(t.reshape(-1).long(), (B,))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, t, *, window: int = 0,
                     ring: bool = False, softcap: float = 0.0,
                     seq_axes=(), Sc: Optional[int] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, 1, Hq, D); caches: (B, S_c, Hkv, D); t = per-seq positions.

    ``ring=True`` treats the cache as a ring buffer of size S_c (sliding
    window): the position of slot s is t - ((t - s) mod S_c).

    Under a mesh whose ``seq_axes`` split the cache's sequence (global
    length ``Sc``), the caches are this rank's sequence block: each block
    computes partial (o, m, l) and the blocks combine with pmax / psum
    over ``seq_axes`` (flattened in their order), no cache gather."""
    B, Sc_loc = k_cache.shape[0], k_cache.shape[1]
    Sc = Sc or Sc_loc
    t = per_seq(t, B, q.device)
    base = 0
    mesh = shlib.current_mesh()
    if seq_axes:
        from repro_torch.parallel import collectives as C
        base = C.axis_index(seq_axes, mesh) * Sc_loc
    slots = base + torch.arange(Sc_loc, device=q.device)
    if ring:
        kpos = t[:, None] - torch.remainder(t[:, None] - slots[None, :], Sc)
    else:
        kpos = torch.broadcast_to(slots[None, :], (B, Sc_loc))
    o, m, l = _decode_attn_local(q, k_cache, v_cache, kpos, t, window,
                                 softcap, scale)
    if seq_axes:
        m_g = C.pmax(m, seq_axes, mesh)
        corr = torch.exp(m - m_g)
        l = C.psum(l * corr, seq_axes, mesh)
        o = C.psum(o * corr[..., None], seq_axes, mesh)
    out = o / l[..., None].clamp_min(1e-37)
    return out.reshape(q.shape).to(q.dtype)


# --------------------------------------------------------------------------- #
# Block-level glue: projections + rope + cache handling
# --------------------------------------------------------------------------- #
def cache_specs(cfg: ModelConfig, batch: int, cache_len: int,
                heads: Optional[int] = None, kv_heads: Optional[int] = None
                ) -> dict:
    kh = kv_heads or cfg.num_kv_heads
    spec = ParamSpec((batch, cache_len, kh, cfg.head_dim),
                     ("batch", "kv_seq", "kv_heads", None),
                     dtype=cfg.act_dtype, init="zeros")
    return {"k": spec, "v": spec}


def _project_qkv(params: dict, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, tp_sp: bool = False):
    """q, k, v (B, S, heads, D) on this rank's head blocks, normed and
    rotated; under ``tp_sp`` the Q projection gathers the sequence inside
    (`_q_col_parallel`) where the mesh allows it."""
    dt = x.dtype
    q = _q_col_parallel(x, params["wq"].to(dt), cfg.num_heads) if tp_sp \
        else None
    if q is None:
        q = torch.einsum("bsd,dhe->bshe", x, params["wq"].to(dt))
    k = torch.einsum("bsd,dhe->bshe", x, params["wk"].to(dt))
    v = torch.einsum("bsd,dhe->bshe", x, params["wv"].to(dt))
    if cfg.qk_norm and "q_norm" in params:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    if cfg.head_dim % 2 == 0:
        if cfg.mrope:
            q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
            k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
        else:
            pos1 = positions if positions.dim() == 2 else positions[0]
            q = apply_rope(q, pos1, cfg.rope_theta)
            k = apply_rope(k, pos1, cfg.rope_theta)
    return q, k, v


def _prefill_attention(cfg: ModelConfig, q, k, v, causal: bool,
                       window: int) -> torch.Tensor:
    """The prefill / train attention of ``cfg.attn_impl`` ("auto": flash
    above 1024 positions; the brick scan where a softcap rules flash
    out), its scores scaled by ``cfg.attn_scale`` (None: 1/sqrt(D))."""
    S = q.shape[1]
    scale = cfg.attn_scale
    impl = cfg.attn_impl
    if impl == "auto":
        impl = "flash" if S > 1024 else "full"
    if impl == "flash" and cfg.attn_logit_softcap:
        impl = "brick"   # flash path has no softcap support
    if impl == "flash":
        from repro_torch.kernels.flash_attention.ops import flash_attention
        return flash_attention(q, k, v, causal, window,
                               min(cfg.attn_chunk_q, S),
                               min(cfg.attn_chunk_kv, S),
                               "pallas" if cfg.use_pallas else "jnp", scale)
    if impl == "brick":
        return brick_attention(q, k, v, causal=causal, window=window,
                               cq=cfg.attn_chunk_q, ck=cfg.attn_chunk_kv,
                               softcap=cfg.attn_logit_softcap, scale=scale)
    return full_attention(q, k, v, causal=causal, window=window,
                          softcap=cfg.attn_logit_softcap, scale=scale)


def group_of_heads(h0: int, n: int, rep: int):
    """The kv heads (or SSM groups) that heads [h0, h0 + n) read, ``rep``
    heads to a group: a slice (lo, hi) when the n heads split evenly over
    hi - lo of them in order, else a list of one group per head."""
    lo, hi = h0 // rep, (h0 + n - 1) // rep + 1
    per = n // (hi - lo)
    if per * (hi - lo) == n and all((h0 + i) // rep - lo == i // per
                                    for i in range(n)):
        return lo, hi
    return [(h0 + i) // rep for i in range(n)]


def kv_for_heads(k: torch.Tensor, q_axes, k_axes, Hq: int, Hkv: int,
                 dim: int = 2) -> torch.Tensor:
    """``k`` (this rank's block of ``Hkv`` kv heads on ``k_axes``, at
    ``dim``) as the kv heads that this rank's block of ``Hq`` query heads
    on ``q_axes`` reads, grouped evenly (GQA): the block itself where both
    split alike, else a slice of the whole kv heads, else one kv head per
    query head."""
    from repro_torch.parallel import collectives as C
    mesh = shlib.current_mesh()
    nq = C.axis_size(q_axes, mesh)
    if tuple(q_axes) == tuple(k_axes) and (Hq // nq) % (Hq // Hkv) == 0:
        return k
    k = C.all_gather(k, k_axes, mesh, axis=dim)
    Hq_loc = Hq // nq
    sel = group_of_heads(C.axis_index(q_axes, mesh) * Hq_loc, Hq_loc,
                         Hq // Hkv)
    if isinstance(sel, tuple):
        return k.narrow(dim, sel[0], sel[1] - sel[0])
    return k.index_select(dim, torch.tensor(sel, device=k.device))


def _pad_heads(cfg: ModelConfig, Hq: int, Hkv: int):
    """(G, g_pad) where ``pad_attn_heads`` pads each kv group of query
    heads from G to g_pad so Hkv * g_pad divides the model axis, or None
    (the reference's rule; never without a mesh)."""
    if not cfg.pad_attn_heads:
        return None
    tp = shlib.axis_sizes(shlib.current_mesh()).get("model", 1)
    if tp <= 1 or Hq % tp == 0:
        return None
    G = Hq // Hkv
    g_pad = G
    while (Hkv * g_pad) % tp and g_pad < G + tp:
        g_pad += 1
    return (G, g_pad) if (Hkv * g_pad) % tp == 0 else None


def _q_col_parallel(x: torch.Tensor, wq: torch.Tensor, Hq: int):
    """The Q projection with the sequence all-gather inside (the
    reference's ``_q_col_parallel``): ``x`` whole is cut to its sequence
    block over ``model`` and gathered back before the product with this
    rank's head columns.  None where the shapes do not divide (or
    without a mesh)."""
    from repro_torch.models.layers import _tp_sp_ok
    ok = _tp_sp_ok(x.shape[1], Hq)
    if ok is None:
        return None
    from repro_torch.parallel import collectives as C
    xg = C.all_gather(C.local_chunk(x, "model", ok, 1), "model", ok, axis=1)
    return torch.einsum("bsd,dhe->bshe", xg, wq)


@spanned("attention_block")
def attention_block(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                    local: bool = False, mode: str = "train",
                    positions: Optional[torch.Tensor] = None,
                    cache: Optional[dict] = None, causal: bool = True,
                    index=None) -> Tuple[torch.Tensor, Optional[dict]]:
    """Self-attention sub-block.  Returns (out, the cache, updated in
    place; None without one).

    Under a mesh every tensor is this rank's block: ``x`` its block of
    the residual stream (gathered to whole sequences here), the weights
    their head blocks, ``cache`` its block of the rules' cache layout;
    the output is its block of the residual stream."""
    from repro_torch.models.layers import (block_input, reduce_to_residual,
                                           to_residual)
    from repro_torch.parallel import collectives as C
    mesh, rules = shlib.current_mesh(), shlib.current_rules()
    x = block_input(x)
    B_loc, S, _ = x.shape
    Bg = shlib.current_dim("batch", B_loc)
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    window = cfg.window_size if local else 0
    if positions is None:
        if mode == "decode":
            positions = per_seq(index, B_loc, x.device)[:, None]
        else:
            positions = torch.broadcast_to(
                torch.arange(S, device=x.device), (B_loc, S))
    dt = x.dtype
    # the weights' head blocks (their param layout)
    qa = shlib._fit_axes(mesh, Hq, rules.mesh_axes("heads"))
    ka = shlib._fit_axes(mesh, Hkv, rules.mesh_axes("kv_heads"))
    q, k, v = _project_qkv(params, x, cfg, positions,
                           tp_sp=cfg.tp_sp and mode != "decode")
    b = act_spec((Bg,), "batch")[0]
    # GQA head padding: when Hq does not divide the model axis, pad each
    # kv group so the heads shard instead of replicating
    pad_g = _pad_heads(cfg, Hq, Hkv)
    Hq_eff = Hq
    if pad_g:      # q is whole here: Hq does not divide the model axis
        G, g_pad = pad_g
        q5 = q.reshape(B_loc, S, Hkv, G, D)
        q = F.pad(q5, (0, 0, 0, g_pad - G)).reshape(B_loc, S, Hkv * g_pad, D)
        Hq_eff = Hkv * g_pad
    # the rules' activation layouts of q, k, v
    q_spec = act_spec((Bg, S, Hq_eff, D), "batch", None, "heads", None)
    k_spec = act_spec((Bg, S, Hkv, D), "batch", None, "kv_heads", None)
    q = C.relayout(q, (b, None, None if pad_g else qa, None), q_spec, mesh)
    k = C.relayout(k, (b, None, ka, None), k_spec, mesh)
    v = C.relayout(v, (b, None, ka, None), k_spec, mesh)
    qa_act, ka_act = entry_axes(q_spec[2]), entry_axes(k_spec[2])

    if mode == "decode":
        if cache is None:
            raise ValueError("decode needs a cache")
        Sc = _global_cache_len(cfg, local, cache)
        c_spec = act_spec((Bg, Sc, Hkv, D), "batch", "kv_seq", "kv_heads",
                          None)
        sa = entry_axes(c_spec[1])
        ring = bool(local and window and Sc <= window)
        idx_vec = per_seq(index, B_loc, x.device)
        slot = torch.remainder(idx_vec, Sc) if ring else idx_vec
        for name, new in (("k", k), ("v", v)):
            new = C.relayout(new, k_spec, (b, None, c_spec[2], None), mesh)
            _cache_write(cache[name], new, slot, Sc, sa)
        if sa:
            # every head of q against this rank's sequence block
            qf = C.relayout(q, q_spec, (b, None, None, None), mesh)
            kc = C.relayout(cache["k"], c_spec, (b, c_spec[1], None, None),
                            mesh)
            vc = C.relayout(cache["v"], c_spec, (b, c_spec[1], None, None),
                            mesh)
            out = decode_attention(qf, kc, vc, index, window=window,
                                   ring=ring, softcap=cfg.attn_logit_softcap,
                                   seq_axes=sa, Sc=Sc,
                                   scale=cfg.attn_scale)
            out = C.relayout(out, (b, None, None, None), q_spec, mesh)
        else:
            ca = entry_axes(c_spec[2])
            kc = kv_for_heads(cache["k"], qa_act, ca, Hq_eff, Hkv)
            vc = kv_for_heads(cache["v"], qa_act, ca, Hq_eff, Hkv)
            out = decode_attention(q, kc, vc, index, window=window,
                                   ring=ring, softcap=cfg.attn_logit_softcap,
                                   scale=cfg.attn_scale)
    else:
        kq = kv_for_heads(k, qa_act, ka_act, Hq_eff, Hkv)
        vq = kv_for_heads(v, qa_act, ka_act, Hq_eff, Hkv)
        out = _prefill_attention(cfg, q, kq, vq, causal, window)
        if mode == "prefill" and cache is not None:
            Sc = _global_cache_len(cfg, local, cache)
            c_spec = act_spec((Bg, Sc, Hkv, D), "batch", "kv_seq",
                              "kv_heads", None)
            for name, new in (("k", k), ("v", v)):
                _cache_fill(cache[name], new, k_spec, c_spec, Sc)
        else:
            cache = None

    if pad_g:
        out = C.relayout(out, q_spec, (b, None, None, None), mesh)
        out = out.reshape(B_loc, S, Hkv, pad_g[1], D)[:, :, :, :pad_g[0]]
        out = out.reshape(B_loc, S, Hq, D)
        qa_act = ()
    elif qa_act != qa:
        out = C.relayout(out, q_spec, (b, None, qa, None), mesh)
        qa_act = qa
    if cfg.tp_sp and mode != "decode" and qa_act:
        from repro_torch.models.layers import row_parallel_proj
        y = row_parallel_proj(out.to(dt), params["wo"].to(dt),
                              "bshe,hed->bsd", Hq * D)
        if y is not None:
            return to_residual(y, (b, "model", None)), cache
    y = torch.einsum("bshe,hed->bsd", out.to(dt), params["wo"].to(dt))
    return reduce_to_residual(y, qa_act), cache


def _global_cache_len(cfg: ModelConfig, local: bool, cache: dict) -> int:
    if shlib.current_mesh() is None:
        return cache["k"].shape[1]
    L = shlib.current_dim("cache_len")
    return min(L, cfg.window_size) if local else L


def _cache_write(cache: torch.Tensor, new: torch.Tensor, slot: torch.Tensor,
                 Sc: int, seq_axes) -> None:
    """Decode: write ``new`` (B, 1, H, D) at each row's global ``slot``
    (clamped into the Sc positions, as `jax.lax.dynamic_update_slice`
    clamps) into ``cache``, this rank's sequence block, where the slot
    falls in it: a masked write, no host sync."""
    from repro_torch.parallel import collectives as C
    Sc_loc = cache.shape[1]
    base = C.axis_index(seq_axes, shlib.current_mesh()) * Sc_loc
    loc = slot.long().clamp(0, Sc - 1) - base
    ok = (loc >= 0) & (loc < Sc_loc)
    loc = loc.clamp(0, Sc_loc - 1)
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, loc] = torch.where(ok[:, None, None],
                                   new[:, 0].to(cache.dtype),
                                   cache[rows, loc])


def _cache_fill(cache: torch.Tensor, new: torch.Tensor, src, c_spec,
                Sc: int) -> None:
    """Prefill: the cache's global positions [0, S) (the last Sc in ring
    order where S > Sc) from ``new`` (B, S, H, D) in layout ``src``, into
    ``cache``, this rank's block of ``c_spec``: a relayout from heads to
    sequence (an all-to-all where one axis moves)."""
    from repro_torch.parallel import collectives as C
    mesh = shlib.current_mesh()
    S = new.shape[1]
    if Sc >= S:
        full = F.pad(new, (0, 0, 0, 0, 0, Sc - S))
        n_valid = S
    else:  # ring (local window) cache keeps the last Sc tokens
        roll = torch.remainder(S - Sc + torch.arange(Sc, device=new.device),
                               Sc)
        full = new[:, -Sc:][:, torch.argsort(roll)]
        n_valid = Sc
    blk = C.relayout(full, (src[0], None, src[2], None), c_spec, mesh)
    Sc_loc = cache.shape[1]
    base = C.axis_index(entry_axes(c_spec[1]), mesh) * Sc_loc
    keep = max(0, min(Sc_loc, n_valid - base))
    cache[:, :keep] = blk[:, :keep].to(cache.dtype)


# --------------------------------------------------------------------------- #
# Cross attention (encoder-decoder)
# --------------------------------------------------------------------------- #
def cross_cache_spec(cfg: ModelConfig, src_len: Optional[int] = None):
    """The rules' layout of a cross k/v (B, S_src, Hkv, D) cache:
    ``("batch", "kv_seq", "kv_heads", None)`` over the global batch and
    ``src_len`` (by default the source length that the serve step
    installed from the caches' ``"src_len"``); all None off a mesh."""
    if shlib.current_mesh() is None:
        return (None,) * 4
    if src_len is None:
        src_len = shlib.current_dim("src_len")
    return act_spec((shlib.current_dim("batch"), src_len, cfg.num_kv_heads,
                     cfg.head_dim), "batch", "kv_seq", "kv_heads", None)


def _cross_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """Attention without a mask of q (B, Sq, Hq, D) over k/v (B, S_src,
    Hkv, D).  One query per sequence attends in one product; a longer
    query runs full attention up to 4096 x 4096 scores, the brick scan
    above."""
    dt = q.dtype
    B, Sq = q.shape[0], q.shape[1]
    if Sq == 1:
        Hq, Hkv, D = q.shape[2], k.shape[2], q.shape[-1]
        q5 = q.reshape(B, 1, Hkv, Hq // Hkv, D)
        s = torch.einsum("bqkgd,bskd->bqkgs", q5, k) / math.sqrt(D)
        p = torch.softmax(s.float(), dim=-1).to(dt)
        out = torch.einsum("bqkgs,bskd->bqkgd", p, v).reshape(q.shape)
    elif Sq * k.shape[1] <= 4096 * 4096:
        out = full_attention(q, k, v, causal=False)
    else:
        out = brick_attention(q, k, v, causal=False, cq=cfg.attn_chunk_q,
                              ck=cfg.attn_chunk_kv)
    return out


def cross_attention_block(params: dict, x: torch.Tensor, enc_kv: Tuple,
                          cfg: ModelConfig) -> torch.Tensor:
    """x: (B, St, d); enc_kv = (k, v[, layout]): (B, S_src, Hkv, D) from
    the encoder's output (`encode_cross_kv`) or the cross caches.

    Under a mesh ``x`` is this rank's block of the residual stream
    (gathered to whole sequences here), the weights their head blocks,
    (k, v) this rank's blocks in ``layout``, which a mesh requires (the
    projections' kv heads, or the caches' `cross_cache_spec`); the
    output is its block of the residual stream, the row-parallel ``wo``
    summed over its head axes.
    A cache whose sequence the rules split is read where it lies: every
    query head against this rank's sequence block, the blocks combined
    with pmax / psum (`decode_attention`, with every position alive)."""
    from repro_torch.models.layers import block_input, reduce_to_residual
    from repro_torch.parallel import collectives as C
    mesh, rules = shlib.current_mesh(), shlib.current_rules()
    x = block_input(x)
    dt = x.dtype
    q = torch.einsum("bsd,dhe->bshe", x, params["wq"].to(dt))
    k, v = enc_kv[0], enc_kv[1]
    if mesh is None:
        out = _cross_attend(q, k, v, cfg)
        return torch.einsum("bshe,hed->bsd", out.to(dt),
                            params["wo"].to(dt))
    Hq, Hkv = cfg.num_heads, cfg.num_kv_heads
    qa = shlib._fit_axes(mesh, Hq, rules.mesh_axes("heads"))
    b = act_spec((shlib.current_dim("batch"),), "batch")[0]
    src = enc_kv[2]
    sa = entry_axes(src[1])
    if sa:
        S_src = k.shape[1] * C.axis_size(sa, mesh)
        qf = C.relayout(q, (b, None, qa, None), (b, None, None, None), mesh)
        kc = C.relayout(k, src, (b, src[1], None, None), mesh)
        vc = C.relayout(v, src, (b, src[1], None, None), mesh)
        out = decode_attention(qf, kc, vc, S_src - 1, seq_axes=sa,
                               Sc=S_src)
        out = C.relayout(out, (b, None, None, None), (b, None, qa, None),
                         mesh)
    else:
        ka = entry_axes(src[2])
        out = _cross_attend(q, kv_for_heads(k, qa, ka, Hq, Hkv),
                            kv_for_heads(v, qa, ka, Hq, Hkv), cfg)
    y = torch.einsum("bshe,hed->bsd", out.to(dt), params["wo"].to(dt))
    return reduce_to_residual(y, qa)


def encode_cross_kv(params: dict, enc_out: torch.Tensor, cfg: ModelConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor, tuple]:
    """The cross-attention k, v (B, S_src, Hkv, D) of the encoder output
    (whole sequences), and their layout: under a mesh this rank's rows
    and the kv heads of its ``wk`` / ``wv`` blocks."""
    dt = enc_out.dtype
    k = torch.einsum("bsd,dhe->bshe", enc_out, params["wk"].to(dt))
    v = torch.einsum("bsd,dhe->bshe", enc_out, params["wv"].to(dt))
    mesh = shlib.current_mesh()
    if mesh is None:
        return k, v, (None,) * 4
    b = act_spec((shlib.current_dim("batch"),), "batch")[0]
    ka = shlib._fit_axes(mesh, cfg.num_kv_heads,
                         shlib.current_rules().mesh_axes("kv_heads"))
    return k, v, (b, None, ka or None, None)
