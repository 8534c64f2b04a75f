"""Oracle for flash attention: materialised scores + mask.

Counterpart of `repro.kernels.flash_attention.ref`; holds both the
brick-scan torch version (`ops.py`) and the CUDA kernel (`kernel.py`).
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D) with Hq % Hkv == 0."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    q5 = q.reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", q5.float(), k.float()) / math.sqrt(D)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(B, Sq, Hq, D).to(q.dtype)
