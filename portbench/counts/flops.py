"""The arithmetic the per-layer metrics divide by that is the chip's or
a kernel's: the chip's peaks, and the operations and bytes of the two
kernels whose roofline share is read.  (A model's parameters and FLOP a
step are its reference module's: ``param_count`` and ``model_flops``,
`reference/ops.py`.)  Frozen here so that a change to the program cannot
move the yardstick; the CPU tests hold them to the program's own counts
(`kernels.ssd.kernel.ssd_ops`, `kernels.flash_attention.kernel`) and to
the numbers the card printed."""
from __future__ import annotations

# NVIDIA H100 SXM, data sheet, dense, at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def ssd_ops(B: int, S: int, H: int, P: int, N: int, chunk: int) -> int:
    """FLOP of the chunked scan: per chunk of Lc steps the causal half of
    C B^T and of its product with x dt, Lc (Lc + 1) (N + P), and the
    state's read and update, 4 Lc N P."""
    L = min(chunk, S)
    per = lambda lc: lc * (lc + 1) * (N + P) + 4 * lc * N * P  # noqa: E731
    return (S // L * per(L) + per(S % L)) * B * H


def ssd_bytes(B: int, S: int, H: int, P: int, G: int, N: int,
              io_bytes: int = 2) -> int:
    """Every input of the scan read once and every output written once:
    x, B, C and y in the activation dtype, dt (B, S, H), A (H,) and the
    final state (B, H, P, N) in float32."""
    return io_bytes * (2 * B * S * H * P + 2 * B * S * G * N) \
        + 4 * (B * S * H + H + B * H * P * N)


def live_pairs(Sq: int, Skv: int, causal: bool, window: int = 0) -> int:
    """(query, key) pairs that the mask keeps, each query's count summed
    in closed form over the stretches where it is linear."""
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


def flash_flops(B: int, Sq: int, Skv: int, Hq: int, D: int, causal: bool,
                window: int = 0) -> int:
    """The attention forward's FLOP: Q K^T and P V, 2 D each, a live pair
    a head."""
    return 4 * B * Hq * D * live_pairs(Sq, Skv, causal, window)


def flash_bytes(B: int, S: int, Hq: int, Hkv: int, D: int,
                io_bytes: int = 2) -> int:
    """q, k, v and the output read or written once, and the float32
    log-sum-exp a query head."""
    return io_bytes * B * S * D * (2 * Hq + 2 * Hkv) + 4 * B * Hq * S


def roofline_ms(flop: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the operations
    at the bf16 peak and the bytes at the memory's bandwidth, in ms."""
    return max(flop / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
