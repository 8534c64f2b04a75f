"""Shared neural building blocks: norms, RoPE (incl. M-RoPE), embeddings,
the LM head and the SwiGLU MLP.

Counterpart of `repro.models.layers`, mesh-free, with its losses: the
sequence-chunked `lm_head_loss` and `cross_entropy`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.sharding import ParamSpec


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
    d = {"embedding": ParamSpec((cfg.vocab_size, cfg.d_model),
                                ("vocab", "embed"), init="embed",
                                scale=0.02)}
    if not cfg.tie_embeddings:
        d["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                 ("embed", "vocab"), scale=1.0)
    d["final_norm"] = norm_spec(cfg.d_model)
    return d


def embed_tokens(params: dict, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    return F.embedding(tokens.long(), params["embedding"]).to(cfg.act_dtype)


def lm_logits(params: dict, x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return torch.einsum("bsd,dv->bsv", x, _head_weight(params, cfg))


def _head_weight(params: dict, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings and "lm_head" not in params:
        return params["embedding"].to(cfg.act_dtype).T
    return params["lm_head"].to(cfg.act_dtype)


def _chunk_nll(xs: torch.Tensor, w: torch.Tensor, lbl: torch.Tensor,
               mk: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the chunk's token NLL, its token count), both f32."""
    logits = torch.einsum("bsd,dv->bsv", xs, w).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lbl.long()[..., None])[..., 0]
    nll = lse - gold
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
    positions past n * c drop out of the mean, as there."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    w = _head_weight(params, cfg)
    S = x.shape[1]
    c = cfg.loss_chunk
    if not c or S <= c:
        return cross_entropy(torch.einsum("bsd,dv->bsv", x, w), labels,
                             mask)
    if S % c:
        c = S // (S // c)  # keep chunks equal; S is a power of two in practice
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(S // c):
        sl = slice(i * c, (i + 1) * c)
        t, n = checkpoint(_chunk_nll, x[:, sl], w, labels[:, sl],
                          None if mask is None else mask[:, sl],
                          use_reentrant=False)
        tot = tot + t
        cnt = cnt + n
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


def mlp_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    gate = torch.einsum("bsd,df->bsf", x, params["wi_gate"].to(dt))
    up = torch.einsum("bsd,df->bsf", x, params["wi_up"].to(dt))
    h = F.silu(gate) * up
    return torch.einsum("bsf,fd->bsd", h, params["wo"].to(dt))
