"""Mamba2 SSD (state-space duality) block, chunked formulation.

Counterpart of `repro.models.ssm`.  Within chunks of length L the output is
a masked (semiseparable) matmul; across chunks a small recurrence on the
(H, P, N) state carries context.  `ssd_scan` here is the chunked torch
version (the ``use_pallas=False`` path); with ``cfg.use_pallas`` the block
calls the CUDA kernel through `repro_torch.kernels.ssd.ops.ssd` (the
`SSDScan` autograd Function, whose backward is this chunked scan's).
``cfg.ssm_conv_bias`` adds a bias to each causal convolution before its
SiLU.  The gated RMS norm is taken over each B/C group's d_inner / G
channels alone, as Mamba2's is (with one group, over all of d_inner).

Under a mesh (`parallel.sharding.sharding_ctx`) `ssd_block` runs on this
rank's SSM heads: ``wz`` / ``wx`` / ``conv_x`` /
``wdt`` / ``A_log`` / ``D`` / ``dt_bias`` / ``gate_norm`` and the rows of
``wo`` are its blocks of ``ssm_inner`` / ``ssm_heads``, ``wB`` / ``wC`` /
``conv_B`` / ``conv_C`` stay whole as the rules say, the scan runs on
the local heads, the gated RMS norm over the sharded d_inner takes its
mean square with a psum (whose backward, a psum too, sums the local
heads' parts of its gradient), and ``wo``'s partial products are summed
over the axes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import rms_norm
from repro_torch.parallel import sharding as shlib
from repro_torch.parallel.sharding import ParamSpec
from repro_torch.spans import spanned


def ssd_specs(cfg: ModelConfig) -> dict:
    d, di = cfg.d_model, cfg.d_inner
    g, n, h, w = (cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads,
                  cfg.ssm_conv_width)
    bias = {}
    if cfg.ssm_conv_bias:
        # each conv's bias as a (1, C) row, the filter's (W, C) layout
        bias = {"conv_x_bias": ParamSpec((1, di), (None, "ssm_inner"),
                                         scale=0.5),
                "conv_B_bias": ParamSpec((1, g * n), (None, None), scale=0.5),
                "conv_C_bias": ParamSpec((1, g * n), (None, None), scale=0.5)}
    return {**bias,
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
                 state: Optional[torch.Tensor] = None,
                 bias: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv along seq, plus ``bias`` (1, C) where given,
    then SiLU.  x: (B,S,C); w: (W,C).

    Returns (y, new_state) where state holds the last W-1 inputs."""
    W, S = w.shape[0], x.shape[1]
    if state is None:
        xp = F.pad(x, (0, 0, W - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + S] * w[i] for i in range(W))
    if bias is not None:
        y = y + bias.to(y.dtype)
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


@spanned("ssd_block")
def ssd_block(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
              mode: str = "train", cache: Optional[dict] = None
              ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Full Mamba2 block: proj -> conv -> SSD -> gated norm -> out proj.
    Returns (out, the cache, updated in place in prefill and decode).

    Under a mesh every tensor is this rank's block: ``x`` its block of
    the residual stream (gathered to whole sequences here), the weights
    and caches their ``ssm_heads`` / ``ssm_inner`` blocks; the output is
    its block of the residual stream."""
    from repro_torch.models.attention import group_of_heads
    from repro_torch.models.layers import block_input, reduce_to_residual
    from repro_torch.parallel import collectives as C
    mesh, rules = shlib.current_mesh(), shlib.current_rules()
    x = block_input(x)
    dt_ = x.dtype
    B, S, _ = x.shape
    H, Pd = cfg.ssm_nheads, cfg.ssm_head_dim
    G, N = cfg.ssm_ngroups, cfg.ssm_state
    ha = shlib._fit_axes(mesh, H, rules.mesh_axes("ssm_heads"))
    ia = shlib._fit_axes(mesh, cfg.d_inner, rules.mesh_axes("ssm_inner"))
    if ha != ia:
        raise NotImplementedError(
            f"ssm_heads ({H}) and ssm_inner ({cfg.d_inner}) split over "
            f"different mesh axes ({ha} and {ia}): the local heads would "
            "not own their d_inner columns")
    H_loc = H // C.axis_size(ha, mesh)
    sel = group_of_heads(C.axis_index(ha, mesh) * H_loc, H_loc, H // G)

    def groups(t: torch.Tensor, dim: int) -> torch.Tensor:
        # the B / C groups the local heads read, evenly
        if isinstance(sel, tuple):
            return t.narrow(dim, sel[0], sel[1] - sel[0])
        return t.index_select(dim, torch.tensor(sel, device=t.device))

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
        xs, conv_x = _conv_step(xs, params["conv_x"], cache["conv_x"],
                                params.get("conv_x_bias"))
        Bp, conv_b = _conv_step(Bp, params["conv_B"], cache["conv_b"],
                                params.get("conv_B_bias"))
        Cp, conv_c = _conv_step(Cp, params["conv_C"], cache["conv_c"],
                                params.get("conv_C_bias"))
        xh = xs.reshape(B, H_loc, Pd)
        Bg = groups(Bp.reshape(B, G, N), 1)
        rep = H_loc // Bg.shape[1]
        Bb = Bg.repeat_interleave(rep, dim=1)                 # (B,H_loc,N)
        Cb = groups(Cp.reshape(B, G, N), 1).repeat_interleave(rep, dim=1)
        dt1 = dt_act[:, 0]                                    # (B,H_loc)
        dA = torch.exp(dt1 * A)
        st = cache["ssm"].float()
        upd = torch.einsum("bh,bhp,bhn->bhpn", dt1, xh.float(), Bb.float())
        st = st * dA[..., None, None] + upd
        y = torch.einsum("bhpn,bhn->bhp", st, Cb.float())
        y = y + params["D"].float()[None, :, None] * xh.float()
        y = y.reshape(B, 1, H_loc * Pd)
        new = {"ssm": st, "conv_x": conv_x, "conv_b": conv_b,
               "conv_c": conv_c}
    else:
        xs, conv_x = _causal_conv(xs, params["conv_x"].to(dt_),
                                  bias=params.get("conv_x_bias"))
        Bp, conv_b = _causal_conv(Bp, params["conv_B"].to(dt_),
                                  bias=params.get("conv_B_bias"))
        Cp, conv_c = _causal_conv(Cp, params["conv_C"].to(dt_),
                                  bias=params.get("conv_C_bias"))
        xh = xs.reshape(B, S, H_loc, Pd)
        Bv = groups(Bp.reshape(B, S, G, N), 2)
        Cv = groups(Cp.reshape(B, S, G, N), 2)
        if cfg.use_pallas:
            from repro_torch.kernels.ssd.ops import ssd as ssd_op
            y, fin = ssd_op(xh, dt_act, A, Bv, Cv, chunk=cfg.ssd_chunk)
        else:
            y, fin = ssd_scan(xh, dt_act, A, Bv, Cv, chunk=cfg.ssd_chunk)
        y = y + params["D"].to(y.dtype)[None, None, :, None] * xh.to(y.dtype)
        y = y.reshape(B, S, H_loc * Pd)
        new = {"ssm": fin, "conv_x": conv_x, "conv_b": conv_b,
               "conv_c": conv_c}
    if mode != "train" and cache is not None:
        for name, t in new.items():
            cache[name].copy_(t)
    else:
        cache = None

    yz = y.to(dt_) * F.silu(z.float()).to(dt_)
    if ia:
        if G > 1:
            raise NotImplementedError("the gated norm over each of several "
                                      "groups of a sharded d_inner")
        # the gated RMS norm over the whole d_inner: its mean square is a
        # psum of the local sums of squares
        ss = torch.sum(yz.square(), dim=-1, keepdim=True,
                       dtype=torch.float32)
        var = C.psum(ss, ia, mesh) / cfg.d_inner
        yz = yz * torch.rsqrt(var + cfg.norm_eps).to(dt_) * (
            1.0 + params["gate_norm"].to(dt_))
    else:
        # over each group's d_inner / G channels alone
        yz = rms_norm(yz.unflatten(-1, (G, -1)),
                      params["gate_norm"].view(G, -1),
                      cfg.norm_eps).flatten(-2)
    out = torch.einsum("bse,ed->bsd", yz, params["wo"].to(dt_))
    return reduce_to_residual(out, ia), cache


def _conv_step(x1: torch.Tensor, w: torch.Tensor, state: torch.Tensor,
               bias: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token causal conv.  x1: (B,1,C); state: (B,W-1,C)."""
    xp = torch.cat([state.to(x1.dtype), x1], dim=1)               # (B,W,C)
    y = torch.einsum("bwc,wc->bc", xp, w.to(x1.dtype))[:, None]
    if bias is not None:
        y = y + bias.to(y.dtype)
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
