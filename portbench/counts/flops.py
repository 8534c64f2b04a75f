"""The arithmetic the per-layer metrics divide by: the chip's peaks, the
model FLOP of a step, and the operations and bytes of the two kernels
whose roofline share is read.  Frozen here so that a change to the
program cannot move the yardstick; the CPU tests hold them to the
program's own counts (`launch.roofline.model_flops_of`,
`kernels.ssd.kernel.ssd_ops`, `kernels.flash_attention.kernel`) and to
the numbers the card printed.

Every function reads a configuration's ``run_as`` dict
(`portbench/configs/*.json`), never the program's config object."""
from __future__ import annotations

# NVIDIA H100 SXM, data sheet, dense, at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def _layers(m: dict):
    for g in m["groups"]:
        for _ in range(g["repeat"]):
            yield from g["layers"]


def layer_params(m: dict, ls: dict, active: bool) -> int:
    """Parameters of one layer (the routed experts' share alone where
    ``active``: each expert leaf times k // E, as the program counts)."""
    d = m["d_model"]
    n = 0
    if ls["mixer"] == "ssd":
        di = m["ssm_expand"] * d
        h = di // m["ssm_head_dim"]
        gn = m["ssm_ngroups"] * m["ssm_state"]
        w = m["ssm_conv_width"]
        n += d + 2 * d * di + 2 * d * gn + d * h + w * di + 2 * w * gn \
            + 3 * h + di + di * d
    elif ls["mixer"] == "attn":
        n += d + attn_params(m, m["num_heads"], m["num_kv_heads"],
                             m["qk_norm"])
    if ls["mlp"] == "dense":
        n += d + 3 * d * m["d_ff"]
    elif ls["mlp"] == "moe":
        E, k, f = m["num_experts"], m["experts_per_token"], m["moe_d_ff"]
        leaf = E * d * f
        n += d + d * E + 3 * (leaf * k // E if active else leaf)
    return n


def attn_params(m: dict, heads: int, kv_heads: int, qk_norm: bool) -> int:
    d, hd = m["d_model"], m["head_dim"]
    return 2 * d * heads * hd + 2 * d * kv_heads * hd + \
        (2 * hd if qk_norm else 0)


def param_count(m: dict, active: bool = False) -> int:
    """Every parameter of the model (embedding, head and final norm
    included)."""
    d, V = m["d_model"], m["vocab_size"]
    n = 2 * V * d + d
    n += sum(layer_params(m, ls, active) for ls in _layers(m))
    if any(ls.get("shared_attn") for ls in _layers(m)):
        n += d + attn_params(m, m["shared_attn_heads"],
                             m["shared_attn_kv_heads"], m["qk_norm"])
    return n


def _attn_layers(m: dict) -> int:
    return sum((ls["mixer"] == "attn") + bool(ls.get("shared_attn"))
               for ls in _layers(m))


def model_flops(m: dict, B: int, S: int, kind: str) -> float:
    """Model FLOP of one step over B sequences of S tokens: 2 N T for a
    prefill and 6 N T for a train step (N the active parameters less
    the embedding, whose lookup is free), plus causal attention,
    4 B (S^2 / 2) H D a layer, three times that in training.  No
    recompute is counted."""
    n = param_count(m, active=m.get("num_experts", 0) > 0) \
        - m["vocab_size"] * m["d_model"]
    attn = 4.0 * B * (S * S / 2) * m["num_heads"] * m["head_dim"] \
        * _attn_layers(m)
    if kind == "train":
        return 6.0 * n * B * S + 3.0 * attn
    if kind == "prefill":
        return 2.0 * n * B * S + attn
    raise ValueError(f"no model FLOP for a {kind!r} step")


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
