"""FlashAttention-2 forward: CUDA kernel for Hopper and its plain PyTorch
version.

Counterpart of `repro.kernels.flash_attention.kernel` (`flash_fwd_pallas` /
`_fwd_kernel`).  `flash_fwd` launches a kernel for CUDA tensors, and takes
`flash_fwd_plain` for CPU tensors.  The kernel's route (`flash_route`) is
decided before the launch by dtype, head dim and alignment:

- bf16 / f16, D a multiple of 8 up to 128, q/k/v/out 16-byte aligned:
  `csrc/flash_fwd_wgmma.cu` (v3: wgmma, TMA loads into a 2-stage ring, a
  producer and two consumer warpgroups, 128-row q and kv tiles);
- bf16 / f16 otherwise (D <= 256): `csrc/flash_fwd_mma.cu` (v2: mma.sync,
  a cp.async ring, 64-row tiles);
- f32: `csrc/flash_fwd.cu` (v1: f32 FMAs on the CUDA cores).

Each walks the kv tiles alive under the causal/window mask for its q tile
(`tile_walk`) with the online softmax.  A launch adds one to
``LAUNCHES["flash_fwd"]`` and one to ``LAUNCHES["flash_fwd.wgmma"]`` or
``["flash_fwd.mma"]`` when it took that route; nowhere else.

Arithmetic, on every route: QK^T in f32 (from f32 operands, or as exact f32
products of 16-bit ones), then times the scale in f32 (the caller's
``scale``, by default 1/sqrt(D); q is never scaled in its own dtype),
masked entries at NEG_INF = -1e30 (not -inf), p
cast to the input dtype before PV, the sum l clamped at 1e-37, so wholly
masked rows give finite numbers as the reference's do.  GQA maps kv head =
q head // (Hq / Hkv).  Like the SSD launch, the launch raises when grad
mode is on and an input requires grad: a gradient goes through
`ops.FlashAttention`.

On CUDA and on meta tensors `flash_fwd` goes through the custom op
``repro_torch::flash_fwd``: its CUDA implementation is the launch, its
registered fake gives the outputs' shapes and dtypes (a meta trace,
`launch.op_analysis`), and its FLOP formula is the bound's, 4 FLOP a
head dim a (query, key) pair alive under the mask (`live_pairs`), so
`torch.utils.flop_counter` counts the kernel's work whatever runs it.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.common import (DTYPE_CODE, FLOAT_TYPES, MMA_TYPES,
                                        check, kernel_op, lib, refuse_grad,
                                        require, stream)
from repro_torch.kernels.flash_attention.ops import brick_fwd

LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_fwd.wgmma": 0,
                            "flash_fwd.mma": 0}
MAX_HEAD_DIM = 256          # what one block holds in shared memory
WGMMA_MAX_HEAD_DIM = 128    # two 64-column boxes of the wgmma kernel
WGMMA_TILE = 128            # its q and kv tile rows
WGMMA_L2_BUDGET = 32 << 20  # the K and V bytes a group of its blocks reads
PLAIN_BLOCK = 128           # the plain version's brick (the Pallas default)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic as a brick scan in torch ops."""
    return brick_fwd(q, k, v, causal, window, PLAIN_BLOCK, PLAIN_BLOCK,
                     f32_scores=True, scale=scale)


def flash_route(dtype: torch.dtype, D: int, *ptrs: int) -> str:
    """The kernel `flash_fwd_launch` (csrc/flash_fwd.cu) runs for these
    inputs: "wgmma" for a 16-bit dtype whose head dim a tensor map and
    wgmma take (a multiple of 8 up to 128) with every base pointer
    (``ptrs``: q, k, v, out) 16-byte aligned, "mma" for any other 16-bit
    input, "v1" for f32."""
    if dtype not in MMA_TYPES:
        return "v1"
    if D % 8 == 0 and D <= WGMMA_MAX_HEAD_DIM and \
            all(p % 16 == 0 for p in ptrs):
        return "wgmma"
    return "mma"


def tile_walk(Sq: int, Skv: int, causal: bool, window: int
              ) -> List[Tuple[int, List[int]]]:
    """The wgmma kernel's walk over one (batch, head), block by block in
    launch order: each q tile's start (the last tile first, the heaviest
    under a causal mask) and the kv tiles it visits, those holding a key
    alive under the mask for some row of the q tile."""
    T, walk = WGMMA_TILE, []
    for q0 in reversed(range(0, Sq, T)):
        k_begin, k_end = 0, Skv
        if causal:
            k_end = min(k_end, q0 + T)
        if window:
            k_begin = max(k_begin, q0 - window + 1)
        lo = k_begin // T
        hi = -(-k_end // T) if k_begin < k_end else lo
        walk.append((q0, list(range(lo, hi))))
    return walk


def block_order(B: int, Sq: int, Skv: int, Hq: int, Hkv: int, D: int
                ) -> List[Tuple[int, int, int]]:
    """The wgmma kernel's blocks in launch order, (q tile start, q head,
    batch): the (batch, head) pairs in the fewest groups of one size
    whose K and V fit in `WGMMA_L2_BUDGET` (a group holds at least one kv
    head, with every q head that reads it), each group's blocks by q tile
    from the last (the heaviest under a causal mask) down, the group's
    pairs in order within a tile."""
    n_qt, pairs, G = -(-Sq // WGMMA_TILE), B * Hq, Hq // Hkv
    # K and V of one kv head: 2 tensors of Skv x D 16-bit values
    most = max(WGMMA_L2_BUDGET // (2 * Skv * D * 2), 1) * G
    n_groups = -(-pairs // most)
    per_group = -(-pairs // n_groups)
    group = min(pairs, -(-per_group // G) * G)   # up to a multiple of G
    order = []
    for blk in range(n_qt * pairs):
        g0 = blk // (group * n_qt) * group
        gs = min(group, pairs - g0)
        within = blk - g0 * n_qt
        pair = g0 + within % gs
        order.append(((n_qt - 1 - within // gs) * WGMMA_TILE, pair % Hq,
                      pair // Hq))
    return order


def _launch_flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool, window: int, entry: str = "launch",
                      scale: Optional[float] = None
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
    if entry == "v2_launch" and q.dtype not in MMA_TYPES:
        raise TypeError(f"flash_fwd_v2 takes {MMA_TYPES}, got {q.dtype}")
    out = torch.empty_like(q)
    lse = torch.empty((B, Sq, Hq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    if Skv == 0:
        raise ValueError("flash_fwd needs at least one key")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    route = {"launch": flash_route(q.dtype, D, *ptrs), "v1_launch": "v1",
             "v2_launch": "mma"}[entry]
    rc = getattr(lib(), f"flash_fwd_{entry}")(
        *ptrs, lse.data_ptr(), B, Sq, Skv, Hq, Hkv, D, int(bool(causal)),
        int(window), DTYPE_CODE[q.dtype], float(scale),
        stream(q.device))
    check(rc, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    if route != "v1":
        LAUNCHES[f"flash_fwd.{route}"] += 1
    return out, lse


def flash_fwd_v1(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = True, window: int = 0,
                 scale: Optional[float] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA-core kernel (`csrc/flash_fwd.cu`) at any dtype, CUDA
    tensors only: the yardstick that the tensor-core routes are timed
    against.  No model path calls it."""
    return _launch_flash_fwd(q, k, v, causal, window, "v1_launch", scale)


def flash_fwd_v2(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = True, window: int = 0,
                 scale: Optional[float] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mma.sync kernel (`csrc/flash_fwd_mma.cu`) at any bf16 / f16
    shape, CUDA tensors only: the yardstick that the wgmma kernel is timed
    against, in turns.  No model path calls it."""
    return _launch_flash_fwd(q, k, v, causal, window, "v2_launch", scale)


def live_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs alive under the mask, query i and key j counted
    from 0 alike: j <= i when causal, j > i - window with a window.  The
    work attention needs, in closed form: the count a query is linear in
    its position between the points where the mask's edges bend (Skv,
    the window, Skv + window - 1), so each stretch is one arithmetic
    series."""
    def alive(q):
        hi = min(Skv - 1, q) if causal else Skv - 1
        lo = max(0, q - window + 1) if window else 0
        return hi - lo + 1
    cuts = {0, Sq}
    for c in (Skv, window, Skv + window - 1) if window else (Skv,):
        if 0 < c < Sq:
            cuts.add(c)
    pts = sorted(cuts)
    n = 0
    for a, b in zip(pts, pts[1:]):
        fa, fb = alive(a), alive(b - 1)
        if fa > 0 and fb > 0:
            n += (b - a) * (fa + fb) // 2
    return n


def flash_fwd_flops(B: int, Sq: int, Skv: int, Hq: int, D: int,
                    causal: bool, window: int) -> int:
    """The forward's FLOP: QK^T and PV, 2 D each, a live pair a head."""
    return 4 * B * Hq * D * live_pairs(Sq, Skv, causal, window)


@torch.library.custom_op("repro_torch::flash_fwd", mutates_args=(),
                         device_types="cuda")
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, window: int, scale: Optional[float] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    return _launch_flash_fwd(q, k, v, causal, window, scale=scale)


@_flash_fwd_op.register_fake
def _(q, k, v, causal, window, scale=None):
    B, Sq, Hq, D = q.shape
    if k.dtype != q.dtype or v.dtype != q.dtype or q.dtype not in FLOAT_TYPES:
        raise TypeError(f"flash_fwd: q, k, v in one of {FLOAT_TYPES}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D \
            or k.shape[2] < 1 or Hq % k.shape[2]:
        raise ValueError(f"flash_fwd: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    return (torch.empty_like(q),
            q.new_empty((B, Sq, Hq), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.flash_fwd)
def _(q_shape, k_shape, v_shape, causal, window, *args, **kwargs) -> int:
    B, Sq, Hq, D = q_shape
    return flash_fwd_flops(B, Sq, k_shape[1], Hq, D, causal, window)


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              scale: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D) -> (out (B,Sq,Hq,D) in q's
    dtype, lse (B,Sq,Hq) f32), the scores scaled by ``scale`` (None:
    1/sqrt(D)).  CUDA tensors launch the kernel (or raise); meta tensors
    take the op's fake; CPU tensors take `flash_fwd_plain`."""
    if kernel_op(q, k, v):
        refuse_grad("flash_fwd", q, k, v)
        return torch.ops.repro_torch.flash_fwd(q, k, v, bool(causal),
                                               int(window), scale)
    return flash_fwd_plain(q, k, v, causal=causal, window=window,
                           scale=scale)
