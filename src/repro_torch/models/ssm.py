"""Mamba2 SSD (state-space duality) block, chunked formulation.

Counterpart of `repro.models.ssm`.  Within chunks of length L the output is
a masked (semiseparable) matmul; across chunks a small recurrence on the
(H, P, N) state carries context.  `ssd_scan` here is the chunked torch
version (the ``use_pallas=False`` path); with ``cfg.use_pallas`` the block
calls the CUDA kernel through `repro_torch.kernels.ssd.ops.ssd` (the
`SSDScan` autograd Function, whose backward is this chunked scan's).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import rms_norm
from repro_torch.parallel.sharding import ParamSpec


def ssd_specs(cfg: ModelConfig) -> dict:
    d, di = cfg.d_model, cfg.d_inner
    g, n, h, w = (cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads,
                  cfg.ssm_conv_width)
    return {
        "wz": ParamSpec((d, di), ("embed", "ssm_inner")),
        "wx": ParamSpec((d, di), ("embed", "ssm_inner")),
        "wB": ParamSpec((d, g * n), ("embed", None)),
        "wC": ParamSpec((d, g * n), ("embed", None)),
        "wdt": ParamSpec((d, h), ("embed", "ssm_heads")),
        "conv_x": ParamSpec((w, di), (None, "ssm_inner"), init="normal",
                            scale=1.0),
        "conv_B": ParamSpec((w, g * n), (None, None)),
        "conv_C": ParamSpec((w, g * n), (None, None)),
        "A_log": ParamSpec((h,), ("ssm_heads",), init="zeros"),
        "D": ParamSpec((h,), ("ssm_heads",), init="ones"),
        "dt_bias": ParamSpec((h,), ("ssm_heads",), init="zeros"),
        "gate_norm": ParamSpec((di,), ("ssm_inner",), init="zeros"),
        "wo": ParamSpec((di, d), ("ssm_inner", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv along seq.  x: (B,S,C); w: (W,C).

    Returns (y, new_state) where state holds the last W-1 inputs."""
    W, S = w.shape[0], x.shape[1]
    if state is None:
        xp = F.pad(x, (0, 0, W - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + S] * w[i] for i in range(W))
    new_state = xp[:, xp.shape[1] - (W - 1):]
    return F.silu(y), new_state


def _segsum_exp(a_cs: torch.Tensor) -> torch.Tensor:
    """(..., L) inclusive cumsum -> (..., L, L) with out[..., i, j] =
    exp(a_cs[i] - a_cs[j]) for i >= j, else 0.

    The upper triangle is masked before the exp, not after it as in the
    reference (``where(tri, exp(diff), 0)``): there diff > 0 grows with
    the chunk (~180 at zamba2's 256) and exp overflows to inf, which the
    forward drops but the backward turns into 0 * inf = NaN.  The values
    are the same."""
    L = a_cs.shape[-1]
    diff = a_cs[..., :, None] - a_cs[..., None, :]
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                device=a_cs.device))
    return torch.exp(torch.where(tri, diff, float("-inf")))


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.  x: (B,S,H,P); dt: (B,S,H); A: (H,) (negative);
    Bm/Cm: (B,S,G,N).  Returns (y: (B,S,H,P), final_state: (B,H,P,N))."""
    Bsz, S, H, Pd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    L = min(chunk, S)
    pad = (-S) % L
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    nc = (S + pad) // L
    rep = H // G

    xc = x.reshape(Bsz, nc, L, H, Pd)
    dtc = dt.reshape(Bsz, nc, L, H).float()
    Bc = Bm.repeat_interleave(rep, dim=2).reshape(Bsz, nc, L, H, N)
    Cc = Cm.repeat_interleave(rep, dim=2).reshape(Bsz, nc, L, H, N)

    dtA = dtc * A.float()                                 # (B,nc,L,H)
    a_cs = torch.cumsum(dtA, dim=2)
    Lmat = _segsum_exp(a_cs.transpose(2, 3))              # (B,nc,H,L,L)
    xdt = xc * dtc[..., None].to(x.dtype)                 # (B,nc,L,H,P)

    # ---- intra-chunk (diagonal blocks) ----
    cb = torch.einsum("bclhn,bcshn->bchls", Cc, Bc)
    m = cb.float() * Lmat
    y_diag = torch.einsum("bchls,bcshp->bclhp", m.to(x.dtype), xdt)

    # ---- chunk states ----
    decay_to_end = torch.exp(a_cs[:, :, -1:, :] - a_cs)   # (B,nc,L,H)
    states = torch.einsum("bclhn,bclh,bclhp->bchpn", Bc.float(),
                          decay_to_end, xdt.float())      # (B,nc,H,P,N)

    # ---- inter-chunk recurrence (emits the state BEFORE each chunk) ----
    chunk_decay = torch.exp(torch.sum(dtA, dim=2))        # (B,nc,H)
    carry = (torch.zeros((Bsz, H, Pd, N), dtype=torch.float32,
                         device=x.device)
             if init_state is None else init_state.float())
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c][..., None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                # (B,nc,H,P,N)

    # ---- inter-chunk contribution ----
    y_off = torch.einsum("bclhn,bchpn,bclh->bclhp", Cc.float(), prev_states,
                         torch.exp(a_cs))
    y = y_diag.float() + y_off
    y = y.reshape(Bsz, nc * L, H, Pd)[:, :S]
    return y.to(x.dtype), carry


def ssd_block(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
              mode: str = "train", cache: Optional[dict] = None
              ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Full Mamba2 block: proj -> conv -> SSD -> gated norm -> out proj."""
    dt_ = x.dtype
    B, S, _ = x.shape
    H, Pd = cfg.ssm_nheads, cfg.ssm_head_dim
    G, N = cfg.ssm_ngroups, cfg.ssm_state

    z = torch.einsum("bsd,de->bse", x, params["wz"].to(dt_))
    xs = torch.einsum("bsd,de->bse", x, params["wx"].to(dt_))
    Bp = torch.einsum("bsd,de->bse", x, params["wB"].to(dt_))
    Cp = torch.einsum("bsd,de->bse", x, params["wC"].to(dt_))
    dtp = torch.einsum("bsd,dh->bsh", x, params["wdt"].to(dt_))

    A = -torch.exp(params["A_log"].float())
    dt_act = F.softplus(dtp.float() + params["dt_bias"].float())

    if mode == "decode":
        if cache is None or S != 1:
            raise ValueError("decode takes one token and a cache")
        xs, conv_x = _conv_step(xs, params["conv_x"], cache["conv_x"])
        Bp, conv_b = _conv_step(Bp, params["conv_B"], cache["conv_b"])
        Cp, conv_c = _conv_step(Cp, params["conv_C"], cache["conv_c"])
        xh = xs.reshape(B, H, Pd)
        Bb = Bp.reshape(B, G, N).repeat_interleave(H // G, dim=1)  # (B,H,N)
        Cb = Cp.reshape(B, G, N).repeat_interleave(H // G, dim=1)
        dt1 = dt_act[:, 0]                                         # (B,H)
        dA = torch.exp(dt1 * A)
        st = cache["ssm"].float()
        upd = torch.einsum("bh,bhp,bhn->bhpn", dt1, xh.float(), Bb.float())
        st = st * dA[..., None, None] + upd
        y = torch.einsum("bhpn,bhn->bhp", st, Cb.float())
        y = y + params["D"].float()[None, :, None] * xh.float()
        y = y.reshape(B, 1, cfg.d_inner)
        new_cache = {"ssm": st.to(cache["ssm"].dtype), "conv_x": conv_x,
                     "conv_b": conv_b, "conv_c": conv_c}
    else:
        xs, conv_x = _causal_conv(xs, params["conv_x"].to(dt_))
        Bp, conv_b = _causal_conv(Bp, params["conv_B"].to(dt_))
        Cp, conv_c = _causal_conv(Cp, params["conv_C"].to(dt_))
        xh = xs.reshape(B, S, H, Pd)
        Bv = Bp.reshape(B, S, G, N)
        Cv = Cp.reshape(B, S, G, N)
        if cfg.use_pallas:
            from repro_torch.kernels.ssd.ops import ssd as ssd_op
            y, fin = ssd_op(xh, dt_act, A, Bv, Cv, chunk=cfg.ssd_chunk)
        else:
            y, fin = ssd_scan(xh, dt_act, A, Bv, Cv, chunk=cfg.ssd_chunk)
        y = y + params["D"].to(y.dtype)[None, None, :, None] * xh.to(y.dtype)
        y = y.reshape(B, S, cfg.d_inner)
        new_cache = None
        if mode == "prefill" and cache is not None:
            new_cache = {"ssm": fin.to(cache["ssm"].dtype),
                         "conv_x": conv_x.to(cache["conv_x"].dtype),
                         "conv_b": conv_b.to(cache["conv_b"].dtype),
                         "conv_c": conv_c.to(cache["conv_c"].dtype)}

    y = rms_norm(y.to(dt_) * F.silu(z.float()).to(dt_), params["gate_norm"],
                 cfg.norm_eps)
    out = torch.einsum("bse,ed->bsd", y, params["wo"].to(dt_))
    return out, new_cache


def _conv_step(x1: torch.Tensor, w: torch.Tensor, state: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token causal conv.  x1: (B,1,C); state: (B,W-1,C)."""
    xp = torch.cat([state.to(x1.dtype), x1], dim=1)               # (B,W,C)
    y = torch.einsum("bwc,wc->bc", xp, w.to(x1.dtype))[:, None]
    return F.silu(y), xp[:, 1:].to(state.dtype)


def ssd_cache_specs(cfg: ModelConfig, batch: int) -> dict:
    H, Pd, G, N, W = (cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_ngroups,
                      cfg.ssm_state, cfg.ssm_conv_width)
    return {
        "ssm": ParamSpec((batch, H, Pd, N),
                         ("batch", "ssm_heads", None, None),
                         dtype=torch.float32, init="zeros"),
        "conv_x": ParamSpec((batch, W - 1, cfg.d_inner),
                            ("batch", None, "ssm_inner"),
                            dtype=cfg.act_dtype, init="zeros"),
        "conv_b": ParamSpec((batch, W - 1, G * N), ("batch", None, None),
                            dtype=cfg.act_dtype, init="zeros"),
        "conv_c": ParamSpec((batch, W - 1, G * N), ("batch", None, None),
                            dtype=cfg.act_dtype, init="zeros"),
    }
