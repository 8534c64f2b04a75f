"""Oracle for the Mamba2 SSD kernel: the O(S^2) quadratic form.

Counterpart of `repro.kernels.ssd.ref`.  `ssd_naive` is the direct
semiseparable matmul, slow but obviously correct;
`repro_torch.models.ssm.ssd_scan` is the chunked torch implementation and
`repro_torch.kernels.ssd.kernel.ssd_scan` the CUDA kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def ssd_naive(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              Bm: torch.Tensor, Cm: torch.Tensor,
              init_state: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,H,P); dt: (B,S,H); A: (H,); Bm/Cm: (B,S,G,N).

    y[t] = sum_{s<=t} C_t . (prod_{r in (s,t]} exp(dtA_r)) dt_s x_s B_s
    Returns (y, final_state)."""
    S, H = x.shape[1], x.shape[2]
    rep = H // Bm.shape[2]
    Bh = Bm.repeat_interleave(rep, dim=2).float()             # (B,S,H,N)
    Ch = Cm.repeat_interleave(rep, dim=2).float()
    dtf = dt.float()
    cum = torch.cumsum(dtf * A.float(), dim=1)                # (B,S,H)
    dec = torch.exp(cum[:, :, None, :] - cum[:, None, :, :])  # (B,T,S,H)
    tri = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                device=x.device))[None, :, :, None]
    dec = torch.where(tri, dec, torch.zeros((), device=x.device))
    m = torch.einsum("bthn,bshn->btsh", Ch, Bh) * dec
    xdt = x.float() * dtf[..., None]
    y = torch.einsum("btsh,bshp->bthp", m, xdt)
    if init_state is not None:
        y = y + torch.einsum("bshn,bhpn,bsh->bshp", Ch, init_state.float(),
                             torch.exp(cum))
    decT = torch.exp(cum[:, -1:, :] - cum)                    # (B,S,H)
    state = torch.einsum("bshn,bsh,bshp->bhpn", Bh, decT, xdt)
    if init_state is not None:
        state = state + init_state.float() * \
            torch.exp(cum[:, -1])[:, :, None, None]
    return y.to(x.dtype), state
