"""FlashAttention-2 forward: CUDA kernel for Hopper and its plain PyTorch
version.

Counterpart of `repro.kernels.flash_attention.kernel` (`flash_fwd_pallas` /
`_fwd_kernel`).  `flash_fwd` launches a kernel for CUDA tensors, and takes
`flash_fwd_plain` for CPU tensors.  The kernel's route follows the dtype:
f32 runs `csrc/flash_fwd.cu` (f32 FMAs on the CUDA cores), bf16 and f16
`csrc/flash_fwd_mma.cu` (mma.sync on the tensor cores, K/V through a
cp.async ring).  Both take one block per (batch, q head, 64-row q tile), a
loop over 64-row kv tiles with the online softmax, kv tiles wholly outside
the causal/window mask skipped.  It adds one to ``LAUNCHES["flash_fwd"]``
where it launches, and one to ``LAUNCHES["flash_fwd.mma"]`` too when the
launch took the tensor-core route; nowhere else.

Arithmetic, in all three: QK^T in f32 (from f32 operands, or as exact f32
products of 16-bit ones), masked entries at NEG_INF = -1e30 (not -inf), p
cast to the input dtype before PV, the sum l clamped at 1e-37, so wholly
masked rows give finite numbers as the reference's do.  GQA maps kv head =
q head // (Hq / Hkv).  Like the SSD launch, the launch raises when grad
mode is on and an input requires grad: a gradient goes through
`ops.FlashAttention`.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels.common import (DTYPE_CODE, FLOAT_TYPES, MMA_TYPES,
                                        check, lib, on_card, refuse_grad,
                                        require, stream)
from repro_torch.kernels.flash_attention.ops import brick_fwd

LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_fwd.mma": 0}
MAX_HEAD_DIM = 256          # what one block holds in shared memory
PLAIN_BLOCK = 128           # the plain version's brick (the Pallas default)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic as a brick scan in torch ops."""
    return brick_fwd(q, k, v, causal, window, PLAIN_BLOCK, PLAIN_BLOCK,
                     f32_scores=True)


def _launch_flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool, window: int, v1: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    refuse_grad("flash_fwd", q, k, v)
    require(q, "q", FLOAT_TYPES, (B, Sq, Hq, D))
    require(k, "k", q.dtype, (B, Skv, Hkv, D))
    require(v, "v", q.dtype, (B, Skv, Hkv, D))
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"kv heads {Hkv} must divide q heads {Hq}")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"flash_fwd kernel takes head_dim <= "
                         f"{MAX_HEAD_DIM}, got {D}")
    out = torch.empty_like(q)
    lse = torch.empty((B, Sq, Hq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    if Skv == 0:
        raise ValueError("flash_fwd needs at least one key")
    entry = lib().flash_fwd_v1_launch if v1 else lib().flash_fwd_launch
    rc = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               lse.data_ptr(), B, Sq, Skv, Hq, Hkv, D, int(bool(causal)),
               int(window), DTYPE_CODE[q.dtype], stream(q.device))
    check(rc, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    if not v1 and q.dtype in MMA_TYPES:
        LAUNCHES["flash_fwd.mma"] += 1
    return out, lse


def flash_fwd_v1(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = True, window: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA-core kernel (`csrc/flash_fwd.cu`) at any dtype, CUDA
    tensors only: the yardstick that the tensor-core route is timed
    against.  No model path calls it."""
    return _launch_flash_fwd(q, k, v, causal, window, v1=True)


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D) -> (out (B,Sq,Hq,D) in q's
    dtype, lse (B,Sq,Hq) f32).  CUDA tensors launch the kernel (or raise);
    CPU tensors take `flash_fwd_plain`."""
    if on_card(q, k, v):
        return _launch_flash_fwd(q, k, v, causal, window)
    return flash_fwd_plain(q, k, v, causal=causal, window=window)
