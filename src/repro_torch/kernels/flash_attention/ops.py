"""FlashAttention-2 as a brick scan, behind a `torch.autograd.Function`.

Counterpart of `repro.kernels.flash_attention.ops`.  The forward walks the
statically enumerated (q-chunk, kv-chunk) bricks alive under the
causal/sliding-window mask with an online softmax; peak memory is O(S.H.D)
plus one brick.  ``impl="pallas"`` takes the kernel
(`kernel.flash_fwd`: the CUDA kernel for CUDA tensors, its plain version for
CPU tensors); any other ``impl`` the brick scan here.

The forward saves only (q, k, v, out, lse); the backward (`brick_bwd`, the
reference's ``_flash_bwd``) re-walks the same brick list in torch ops and
accumulates dq, dk and dv in f32, for either forward.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def brick_list(nq: int, nk: int, cq: int, ck: int, causal: bool,
               window: int) -> List[Tuple[int, int]]:
    """Statically enumerate (q-chunk, kv-chunk) bricks needed under the mask."""
    pairs = []
    for i in range(nq):
        q_lo, q_hi = i * cq, (i + 1) * cq - 1
        for j in range(nk):
            k_lo, k_hi = j * ck, (j + 1) * ck - 1
            if causal and k_lo > q_hi:
                continue
            if window and k_hi <= q_lo - window:
                continue
            pairs.append((i, j))
    return pairs


def _pad_seq(x: torch.Tensor, c: int) -> torch.Tensor:
    pad = (-x.shape[1]) % c
    return F.pad(x, (0, 0, 0, 0, 0, pad)) if pad else x


def brick_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: int = 0, cq: int = 1024,
              ck: int = 1024, *, softcap: float = 0.0,
              f32_scores: bool = False, scale: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Online-softmax attention over the live bricks.  q: (B,Sq,Hq,D);
    k/v: (B,Skv,Hkv,D).  Returns (out (B,Sq,Hq,D) in q's dtype, lse
    (B,Sq,Hq) f32).  The scores are scaled by ``scale`` (None:
    1/sqrt(D)) in f32, after the product.

    The scores QK^T come out in q's dtype (as the reference's einsum gives
    them), or in f32 from f32 operands with ``f32_scores`` (as the kernel
    computes them); p is cast to q's dtype before PV either way."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    cq, ck = min(cq, Sq), min(ck, Skv)
    qp, kp, vp = _pad_seq(q, cq), _pad_seq(k, ck), _pad_seq(v, ck)
    nq, nk = qp.shape[1] // cq, kp.shape[1] // ck
    qc = qp.reshape(B, nq, cq, Hkv, G, D)
    kc = kp.reshape(B, nk, ck, Hkv, D)
    vc = vp.reshape(B, nk, ck, Hkv, D)
    if f32_scores:
        qc, kc = qc.float(), kc.float()
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    dev = q.device
    neg = torch.full((), NEG_INF, device=dev)

    acc = [torch.zeros((B, cq, Hkv, G, D), dtype=torch.float32, device=dev)
           for _ in range(nq)]
    m = [torch.full((B, cq, Hkv, G), NEG_INF, dtype=torch.float32,
                    device=dev) for _ in range(nq)]
    l = [torch.zeros((B, cq, Hkv, G), dtype=torch.float32, device=dev)
         for _ in range(nq)]
    for i, j in brick_list(nq, nk, cq, ck, causal, window):
        s = torch.einsum("bqkgd,bskd->bqkgs", qc[:, i], kc[:, j]).float()
        s = s * scale
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        qpos = i * cq + torch.arange(cq, device=dev)[:, None]
        kpos = j * ck + torch.arange(ck, device=dev)[None, :]
        mask = kpos < Skv
        if causal:
            mask = mask & (kpos <= qpos)
        if window:
            mask = mask & (kpos > qpos - window)
        s = torch.where(mask[:, None, None, :], s, neg)
        m_new = torch.maximum(m[i], s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m[i] - m_new)
        l[i] = l[i] * corr + p.sum(dim=-1)
        pv = torch.einsum("bqkgs,bskd->bqkgd", p.to(q.dtype), vc[:, j])
        acc[i] = acc[i] * corr[..., None] + pv.float()
        m[i] = m_new
    lt = torch.stack(l, dim=1).clamp_min(1e-37)               # (B,nq,cq,Hkv,G)
    out = torch.stack(acc, dim=1) / lt[..., None]
    lse = torch.stack(m, dim=1) + torch.log(lt)
    out = out.reshape(B, nq * cq, Hq, D)[:, :Sq].to(q.dtype)
    return out, lse.reshape(B, nq * cq, Hq)[:, :Sq]


def brick_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
              causal: bool = True, window: int = 0, cq: int = 1024,
              ck: int = 1024, *, f32_scores: bool = False,
              scale: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of attention over the live bricks, from the forward's
    (out, lse (B,Sq,Hq) f32) and dout.  Returns (dq, dk, dv) in the
    inputs' dtypes, accumulated in f32.  The scores are recomputed as the
    forward computed them: in q's dtype, or in f32 from f32 operands with
    ``f32_scores`` (the kernel's); p and ds are cast to the inputs' dtype
    before their matmuls, as in the reference."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    cq, ck = min(cq, Sq), min(ck, Skv)
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    qp, kp, vp = _pad_seq(q, cq), _pad_seq(k, ck), _pad_seq(v, ck)
    dop, outp = _pad_seq(dout, cq), _pad_seq(out, cq)
    nq, nk = qp.shape[1] // cq, kp.shape[1] // ck
    # the one place where the (B, Sq, Hq) lse takes the brick layout
    lsec = F.pad(lse.reshape(B, Sq, Hkv, G),
                 (0, 0, 0, 0, 0, nq * cq - Sq)).reshape(B, nq, cq, Hkv, G)
    qc = qp.reshape(B, nq, cq, Hkv, G, D)
    kc = kp.reshape(B, nk, ck, Hkv, D)
    vc = vp.reshape(B, nk, ck, Hkv, D)
    doc = dop.reshape(B, nq, cq, Hkv, G, D)
    # delta = rowsum(dO * O)
    delta = torch.sum(dop.float() * outp.float(),
                      dim=-1).reshape(B, nq, cq, Hkv, G)
    qs, ks = (qc.float(), kc.float()) if f32_scores else (qc, kc)
    dev = q.device
    neg = torch.full((), NEG_INF, device=dev)

    dq = [torch.zeros((B, cq, Hkv, G, D), dtype=torch.float32, device=dev)
          for _ in range(nq)]
    dk = [torch.zeros((B, ck, Hkv, D), dtype=torch.float32, device=dev)
          for _ in range(nk)]
    dv = [torch.zeros((B, ck, Hkv, D), dtype=torch.float32, device=dev)
          for _ in range(nk)]
    for i, j in brick_list(nq, nk, cq, ck, causal, window):
        qi, kj, vj, doi = qc[:, i], kc[:, j], vc[:, j], doc[:, i]
        s = torch.einsum("bqkgd,bskd->bqkgs", qs[:, i], ks[:, j]).float()
        s = s * scale
        qpos = i * cq + torch.arange(cq, device=dev)[:, None]
        kpos = j * ck + torch.arange(ck, device=dev)[None, :]
        mask = kpos < Skv
        if causal:
            mask = mask & (kpos <= qpos)
        if window:
            mask = mask & (kpos > qpos - window)
        s = torch.where(mask[:, None, None, :], s, neg)
        p = torch.exp(s - lsec[:, i][..., None])          # (B,cq,Hkv,G,ck)
        dvj = torch.einsum("bqkgs,bqkgd->bskd", p.to(dout.dtype), doi)
        dp = torch.einsum("bqkgd,bskd->bqkgs", doi, vj).float()
        ds = p * (dp - delta[:, i][..., None]) * scale
        dsq = ds.to(q.dtype)
        dq[i] += torch.einsum("bqkgs,bskd->bqkgd", dsq, kj).float()
        dk[j] += torch.einsum("bqkgs,bqkgd->bskd", dsq, qi).float()
        dv[j] += dvj.float()
    dq_ = torch.stack(dq, dim=1).reshape(B, nq * cq, Hq, D)[:, :Sq]
    dk_ = torch.stack(dk, dim=1).reshape(B, nk * ck, Hkv, D)[:, :Skv]
    dv_ = torch.stack(dv, dim=1).reshape(B, nk * ck, Hkv, D)[:, :Skv]
    return dq_.to(q.dtype), dk_.to(k.dtype), dv_.to(v.dtype)


def _flash_fwd(q, k, v, causal, window, cq, ck, impl, scale):
    if impl == "pallas":
        from repro_torch.kernels.flash_attention.kernel import flash_fwd
        return flash_fwd(q, k, v, causal=causal, window=window, scale=scale)
    return brick_fwd(q, k, v, causal, window, cq, ck, scale=scale)


class FlashAttention(torch.autograd.Function):
    """out = attention(q, k, v); saves (q, k, v, out, lse), and its
    backward is `brick_bwd` on them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, cq, ck, impl, scale=None):
        out, lse = _flash_fwd(q, k, v, causal, window, cq, ck, impl, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, cq, ck, impl == "pallas", scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, cq, ck, f32_scores, scale = ctx.args
        dq, dk, dv = brick_bwd(q, k, v, out, lse, dout.contiguous(), causal,
                               window, cq, ck, f32_scores=f32_scores,
                               scale=scale)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0, cq: int = 1024,
                    ck: int = 1024, impl: str = "jnp",
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,Sq,Hq,D); k/v: (B,Skv,Hkv,D) -> (B,Sq,Hq,D), the scores
    scaled by ``scale`` (None: 1/sqrt(D))."""
    return FlashAttention.apply(q, k, v, causal, window, cq, ck, impl,
                                scale)
