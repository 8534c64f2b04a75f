"""The Mamba2 SSD chunked scan: CUDA kernel for Hopper and its plain
PyTorch version.

Counterpart of `repro.kernels.ssd.kernel` (`ssd_pallas` / `_ssd_kernel`).
Within a chunk of L steps, with cum the inclusive cumsum of dt*A:

   y      = ((C B^T) .* tril exp(cum_i - cum_j)) (dt x)      intra-chunk
          + (C state_in^T) .* exp(cum)                        inter-chunk
   state  = state_in * exp(cum_L) + (dt x .* exp(cum_L - cum))^T B

all in f32, the chunks' states carried in order.  `ssd_scan` launches a
kernel for CUDA tensors and takes `ssd_scan_plain` for CPU tensors.  The
kernel's route (`ssd_route`) is decided before the launch by dtype,
shape and alignment:

- bf16, P and N multiples of 8 up to 128, a chunk the kernel takes
  (`wgmma_chunk`: a multiple of 64 up to 256, or one chunk of S),
  x/Bm/Cm/y 16-byte aligned: `csrc/ssd_scan_wgmma.cu`
  (v3: one block a chunk, TMA, wgmma, the chunks' states scanned across
  a thread-block cluster; `cluster_walk`);
- bf16 otherwise: `csrc/ssd_scan_mma.cu` (v2: one block per (batch,
  head, slice of P) walking its chunks, mma.sync);
- f32 and f16: `csrc/ssd_scan.cu` (v1: f32 FMAs on the CUDA cores, M kept
  in f32).  f16 stays off the tensor-core routes because an f16 M
  overflows above 65504 where the reference's f32 M does not.

Rounding points: v3 rounds M and the update's dt exp(cum_L - cum) x to
bf16 and the state, as the operand of C state^T, to tf32; v2 rounds M to
bf16 and the state and the update's scaled x to tf32; both carry the
state in f32.  A launch adds one to ``LAUNCHES["ssd_scan"]`` and one to
``LAUNCHES["ssd_scan.wgmma"]`` or ``["ssd_scan.mma"]`` when it took that
route; nowhere else.  The launch gives outputs that autograd cannot see
through, so it raises when grad mode is on and an input requires grad: a
gradient goes through `kernels.ssd.ops.SSDScan`.

On CUDA and on meta tensors `ssd_scan` goes through the custom op
``repro_torch::ssd_scan``: its CUDA implementation is the launch, its
registered fake gives the outputs' shapes and dtypes (a meta trace,
`launch.op_analysis`), and its FLOP formula is the bound's chunked FLOP
(`ssd_ops`), so `torch.utils.flop_counter` counts the kernel's work.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.common import (DTYPE_CODE, FLOAT_TYPES, check,
                                        kernel_op, lib, refuse_grad, require,
                                        stream)
from repro_torch.models.ssm import ssd_scan as chunked_scan

LAUNCHES: Dict[str, int] = {"ssd_scan": 0, "ssd_scan.wgmma": 0,
                            "ssd_scan.mma": 0}
# what one block of the kernels holds in shared memory (csrc/ssd_scan.cu,
# csrc/ssd_scan_mma.cu)
MAX_HEAD_DIM = 128
MAX_STATE = 128
MAX_CHUNK = 1024
# the wgmma kernel (csrc/ssd_scan_wgmma.cu): 64-row tiles, chunks of up to
# four, clusters of 8 blocks along the chunks
WGMMA_TILE = 64
WGMMA_MAX_CHUNK = 256
WGMMA_CLUSTER = 8


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = 128
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in torch ops: the chunked scan of
    `models.ssm` on f32 operands (f32 throughout, the chunks' states
    carried in order).  Returns (y (B,S,H,P) in x's dtype, final_state
    (B,H,P,N) f32)."""
    y, fin = chunked_scan(x.float(), dt.float(), A.float(), Bm.float(),
                          Cm.float(), chunk)
    return y.to(x.dtype), fin


def wgmma_chunk(S: int, L: int) -> int:
    """The chunk the wgmma kernel walks for L = min(chunk, S): L where S
    spans several chunks, S rounded up to a 64-row tile where one chunk
    holds it (the same scan: a lone chunk's length past S changes
    nothing)."""
    return L if L < S else -(-S // WGMMA_TILE) * WGMMA_TILE


def ssd_route(dtype: torch.dtype, P: int, N: int, L: int, *ptrs: int
              ) -> str:
    """The kernel `ssd_scan_launch` (csrc/ssd_scan.cu) runs for these
    inputs: "wgmma" for bf16 whose P and N are multiples of 8 up to 128
    and whose chunk ``L`` (the one the kernel walks, `wgmma_chunk`) is a
    multiple of 64 up to 256, with every base pointer (``ptrs``: x, Bm,
    Cm, y) 16-byte aligned; "mma" for any other bf16 input; "v1" for f32
    and f16."""
    if dtype != torch.bfloat16:
        return "v1"
    fits = (all(d % 8 == 0 and 8 <= d <= 128 for d in (P, N))
            and L % WGMMA_TILE == 0 and WGMMA_TILE <= L <= WGMMA_MAX_CHUNK)
    if fits and all(p % 16 == 0 for p in ptrs):
        return "wgmma"
    return "mma"


def cluster_walk(n_chunks: int) -> Tuple[int, List[List[int]]]:
    """The wgmma kernel's blocks of one (batch, head, 64-column slice of
    P): the cluster size CL (8, or 1 where one chunk holds S) and the
    chunks each block r takes in rounds, r, r + CL, ...  Each round, block
    k scans rows [8k, 8k + 8) of the slice's state over the round's chunks
    in order and hands each chunk's entering rows back to its block."""
    CL = WGMMA_CLUSTER if n_chunks > 1 else 1
    return CL, [list(range(r, n_chunks, CL)) for r in range(CL)]


def _launch_ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                     entry: str = "launch"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    Bsz, S, H, Pd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    refuse_grad("ssd_scan", x, dt, A, Bm, Cm)
    require(x, "x", FLOAT_TYPES, (Bsz, S, H, Pd))
    require(dt, "dt", torch.float32, (Bsz, S, H))
    require(A, "A", torch.float32, (H,))
    require(Bm, "Bm", x.dtype, (Bsz, S, G, N))
    require(Cm, "Cm", x.dtype, (Bsz, S, G, N))
    L = min(int(chunk), S)
    if G < 1 or H % G:
        raise ValueError(f"groups G={G} must divide heads H={H}")
    if Pd > MAX_HEAD_DIM or N > MAX_STATE or L > MAX_CHUNK:
        raise ValueError(f"ssd_scan kernel takes P <= {MAX_HEAD_DIM}, "
                         f"N <= {MAX_STATE}, chunk <= {MAX_CHUNK}; got "
                         f"P={Pd} N={N} chunk={L}")
    if entry == "v2_launch" and x.dtype != torch.bfloat16:
        raise TypeError(f"ssd_scan_v2 takes bfloat16, got {x.dtype}")
    y = torch.empty_like(x)
    fin = torch.empty((Bsz, H, Pd, N), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        fin.zero_()
        return y, fin
    route = {"launch": ssd_route(x.dtype, Pd, N, wgmma_chunk(S, L),
                                 x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                                 y.data_ptr()),
             "v1_launch": "v1", "v2_launch": "mma"}[entry]
    rc = getattr(lib(), f"ssd_scan_{entry}")(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), fin.data_ptr(), Bsz, S, H, Pd, G, N, L,
        DTYPE_CODE[x.dtype], stream(x.device))
    check(rc, "ssd_scan")
    LAUNCHES["ssd_scan"] += 1
    if route != "v1":
        LAUNCHES[f"ssd_scan.{route}"] += 1
    return y, fin


def ssd_scan_v1(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = 128
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA-core kernel (`csrc/ssd_scan.cu`) at any dtype, CUDA tensors
    only: the yardstick that the tensor-core routes are timed against.  No
    model path calls it."""
    return _launch_ssd_scan(x, dt, A, Bm, Cm, chunk, "v1_launch")


def ssd_scan_v2(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = 128
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mma.sync kernel (`csrc/ssd_scan_mma.cu`) at any bf16 shape, CUDA
    tensors only: the yardstick that the wgmma kernel is timed against, in
    turns.  No model path calls it."""
    return _launch_ssd_scan(x, dt, A, Bm, Cm, chunk, "v2_launch")


def ssd_ops(B: int, S: int, H: int, P: int, N: int, chunk: int) -> int:
    """FLOP of the chunked scan over the real steps, in closed form: per
    chunk of Lc steps the causal half of C B^T and of its product with
    x dt, Lc(Lc+1)(N+P), plus the state's read and update, 4 Lc N P;
    S // L whole chunks of L = min(chunk, S) and one of S % L."""
    L = min(chunk, S)
    if L <= 0:
        return 0
    per = lambda lc: lc * (lc + 1) * (N + P) + 4 * lc * N * P  # noqa: E731
    return (S // L * per(L) + per(S % L)) * B * H


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=(),
                         device_types="cuda")
def _ssd_scan_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, chunk: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    return _launch_ssd_scan(x, dt, A, Bm, Cm, chunk)


@_ssd_scan_op.register_fake
def _(x, dt, A, Bm, Cm, chunk):
    Bsz, S, H, Pd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if dt.shape != (Bsz, S, H) or A.shape != (H,) \
            or Bm.shape != (Bsz, S, G, N) or Cm.shape != Bm.shape \
            or G < 1 or H % G:
        raise ValueError(f"ssd_scan: dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)}, Bm {tuple(Bm.shape)}, Cm "
                         f"{tuple(Cm.shape)} do not fit x {tuple(x.shape)}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32 \
            or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError("ssd_scan: dt and A in f32, Bm and Cm in x's dtype")
    return (torch.empty_like(x),
            x.new_empty((Bsz, H, Pd, N), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.ssd_scan)
def _(x_shape, dt_shape, A_shape, Bm_shape, Cm_shape, chunk, *args,
      **kwargs) -> int:
    Bsz, S, H, Pd = x_shape
    return ssd_ops(Bsz, S, H, Pd, Bm_shape[3], chunk)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,H,P); dt: (B,S,H) f32; A: (H,) f32; Bm/Cm: (B,S,G,N) in x's
    dtype with G | H.  Returns (y (B,S,H,P), final_state (B,H,P,N) f32).
    CUDA tensors launch the kernel (or raise); meta tensors take the op's
    fake; CPU tensors take `ssd_scan_plain`."""
    if kernel_op(x, dt, A, Bm, Cm):
        refuse_grad("ssd_scan", x, dt, A, Bm, Cm)
        return torch.ops.repro_torch.ssd_scan(x, dt, A, Bm, Cm, int(chunk))
    return ssd_scan_plain(x, dt, A, Bm, Cm, chunk)
