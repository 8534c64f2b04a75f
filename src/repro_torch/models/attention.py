"""Attention: GQA projections + three execution strategies, mesh-free.

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
(`cross_attention_block`).  The shard_map paths of the reference
(sequence-sharded flash-decode, column/row-parallel projections) come with
the parallel slice.

Caches are updated in place: the prefill and decode writes go into the
cache tensors the caller passed (the reference returns new arrays), which
saves a copy of every cache per step.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import brick_fwd
from repro_torch.models.layers import (apply_mrope, apply_rope, norm_spec,
                                       rms_norm)
from repro_torch.parallel.sharding import ParamSpec

NEG_INF = -1e30


# --------------------------------------------------------------------------- #
# Parameter specs
# --------------------------------------------------------------------------- #
def attn_specs(cfg: ModelConfig, heads: Optional[int] = None,
               kv_heads: Optional[int] = None, cross: bool = False) -> dict:
    h = heads or cfg.num_heads
    kh = kv_heads or cfg.num_kv_heads
    d = cfg.head_dim
    specs = {
        "wq": ParamSpec((cfg.d_model, h, d), ("embed", "heads", None)),
        "wk": ParamSpec((cfg.d_model, kh, d), ("embed", "kv_heads", None)),
        "wv": ParamSpec((cfg.d_model, kh, d), ("embed", "kv_heads", None)),
        "wo": ParamSpec((h, d, cfg.d_model), ("heads", None, "embed")),
    }
    if cfg.qk_norm and not cross:
        specs["q_norm"] = norm_spec(d)
        specs["k_norm"] = norm_spec(d)
    return specs


def cross_attn_specs(cfg: ModelConfig) -> dict:
    return attn_specs(cfg, cross=True)


def _softcap(scores: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0.0:
        return cap * torch.tanh(scores / cap)
    return scores


# --------------------------------------------------------------------------- #
# full-scores attention
# --------------------------------------------------------------------------- #
def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int = 0,
                   softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D).  Returns (B, Sq, Hq, D)."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    q5 = q.reshape(B, Sq, Hkv, G, D)
    scores = torch.einsum("bqkgd,bskd->bkgqs", q5, k) / math.sqrt(D)
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
                    softcap: float = 0.0) -> torch.Tensor:
    """Blocked online-softmax attention over the needed bricks only."""
    out, _ = brick_fwd(q, k, v, causal, window, cq, ck, softcap=softcap)
    return out


# --------------------------------------------------------------------------- #
# decode attention
# --------------------------------------------------------------------------- #
def _decode_attn_local(q, k, v, kpos, t, window, softcap):
    """Attention of one token per sequence over its cache -> (o, m, l)
    un-normalised.  kpos: (B, Sc) positions of the cache slots (< 0 marks
    ring slots not yet written); t: (B,) each sequence's position."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    q5 = q.reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqkgd,bskd->bqkgs", q5, k) / math.sqrt(D)
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
                     ring: bool = False, softcap: float = 0.0
                     ) -> torch.Tensor:
    """q: (B, 1, Hq, D); caches: (B, S_c, Hkv, D); t = per-seq positions.

    ``ring=True`` treats the cache as a ring buffer of size S_c (sliding
    window): the position of slot s is t - ((t - s) mod S_c)."""
    B, Sc = k_cache.shape[0], k_cache.shape[1]
    t = per_seq(t, B, q.device)
    slots = torch.arange(Sc, device=q.device)
    if ring:
        kpos = t[:, None] - torch.remainder(t[:, None] - slots[None, :], Sc)
    else:
        kpos = torch.broadcast_to(slots[None, :], (B, Sc))
    o, m, l = _decode_attn_local(q, k_cache, v_cache, kpos, t, window,
                                 softcap)
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
                 positions: torch.Tensor):
    dt = x.dtype
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


def attention_block(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                    local: bool = False, mode: str = "train",
                    positions: Optional[torch.Tensor] = None,
                    cache: Optional[dict] = None, causal: bool = True,
                    index=None) -> Tuple[torch.Tensor, Optional[dict]]:
    """Self-attention sub-block.  Returns (out, new_cache)."""
    B, S, _ = x.shape
    window = cfg.window_size if local else 0
    if positions is None:
        if mode == "decode":
            positions = per_seq(index, B, x.device)[:, None]
        else:
            positions = torch.broadcast_to(
                torch.arange(S, device=x.device), (B, S))

    q, k, v = _project_qkv(params, x, cfg, positions)

    new_cache = None
    if mode == "decode":
        if cache is None:
            raise ValueError("decode needs a cache")
        Sc = cache["k"].shape[1]
        ring = bool(local and window and Sc <= window)
        idx_vec = per_seq(index, B, x.device)
        slot = torch.remainder(idx_vec, Sc) if ring else idx_vec
        k_cache = _cache_update(cache["k"], k, slot)
        v_cache = _cache_update(cache["v"], v, slot)
        out = decode_attention(q, k_cache, v_cache, index, window=window,
                               ring=ring, softcap=cfg.attn_logit_softcap)
        new_cache = {"k": k_cache, "v": v_cache}
    else:
        impl = cfg.attn_impl
        if impl == "auto":
            impl = "flash" if S > 1024 else "full"
        if impl == "flash" and cfg.attn_logit_softcap:
            impl = "brick"   # flash path has no softcap support
        if impl == "flash":
            from repro_torch.kernels.flash_attention.ops import \
                flash_attention
            out = flash_attention(q, k, v, causal, window,
                                  min(cfg.attn_chunk_q, S),
                                  min(cfg.attn_chunk_kv, S),
                                  "pallas" if cfg.use_pallas else "jnp")
        elif impl == "brick":
            out = brick_attention(q, k, v, causal=causal, window=window,
                                  cq=cfg.attn_chunk_q, ck=cfg.attn_chunk_kv,
                                  softcap=cfg.attn_logit_softcap)
        else:
            out = full_attention(q, k, v, causal=causal, window=window,
                                 softcap=cfg.attn_logit_softcap)
        if mode == "prefill" and cache is not None:
            Sc = cache["k"].shape[1]
            if Sc >= S:
                k_cache = _cache_update(cache["k"], k, 0)
                v_cache = _cache_update(cache["v"], v, 0)
            else:  # ring (local window) cache keeps the last Sc tokens
                roll = torch.remainder(
                    S - Sc + torch.arange(Sc, device=x.device), Sc)
                order = torch.argsort(roll)
                k_cache = cache["k"]
                v_cache = cache["v"]
                k_cache.copy_(k[:, -Sc:][:, order])
                v_cache.copy_(v[:, -Sc:][:, order])
            new_cache = {"k": k_cache, "v": v_cache}

    dt = x.dtype
    y = torch.einsum("bshe,hed->bsd", out.to(dt), params["wo"].to(dt))
    return y, new_cache


def _cache_update(cache: torch.Tensor, kv: torch.Tensor,
                  slot: Union[int, torch.Tensor]) -> torch.Tensor:
    """Write kv (B, S_new, ...) into ``cache`` (B, S_c, ...) in place at
    each sequence's slot (a scalar, or a (B,) vector: continuous batching
    gives every sequence its own write position) and return it.  Slots are
    clamped so the write fits, as `jax.lax.dynamic_update_slice` clamps."""
    Sc, Sn = cache.shape[1], kv.shape[1]
    kv = kv.to(cache.dtype)
    if isinstance(slot, int):
        start = min(max(slot, 0), Sc - Sn)
        cache[:, start:start + Sn] = kv
        return cache
    start = slot.long().clamp(0, Sc - Sn)
    if Sn == 1:
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, start] = kv[:, 0]
        return cache
    for b, s0 in enumerate(start.tolist()):
        cache[b, s0:s0 + Sn] = kv[b]
    return cache


# --------------------------------------------------------------------------- #
# Cross attention (encoder-decoder)
# --------------------------------------------------------------------------- #
def cross_attention_block(params: dict, x: torch.Tensor, enc_kv: Tuple,
                          cfg: ModelConfig) -> torch.Tensor:
    """x: (B, St, d); enc_kv = (k, v), (B, S_src, Hkv, D), precomputed from
    the encoder's output.  One query per sequence attends in one product;
    a longer query runs full attention up to 4096 x 4096 scores, the brick
    scan above."""
    dt = x.dtype
    q = torch.einsum("bsd,dhe->bshe", x, params["wq"].to(dt))
    k, v = enc_kv
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
    return torch.einsum("bshe,hed->bsd", out.to(dt), params["wo"].to(dt))


def encode_cross_kv(params: dict, enc_out: torch.Tensor, cfg: ModelConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross-attention k, v (B, S_src, Hkv, D) of the encoder output."""
    dt = enc_out.dtype
    k = torch.einsum("bsd,dhe->bshe", enc_out, params["wk"].to(dt))
    v = torch.einsum("bsd,dhe->bshe", enc_out, params["wv"].to(dt))
    return k, v
