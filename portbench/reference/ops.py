"""The plain reference of the port's layer stack (the layouts of
`repro_torch.configs`): every block written out in float32 PyTorch from
its equations, with no kernel, cache or batching of the program under
test.  It imports nothing of that program.

**A reference module.**  A configuration file names the benchmark's model
of its architecture in its top-level key ``"reference"``: the module
``portbench/reference/<name>.py``, loaded once a process
(`harness.reference_module`).  Everything that knows an architecture is
there; the judge (`check`), the loops, `reference/train.py` and the
metric readers take the module and import none.  Such a module exports:

- ``embed(params, tokens)``: the stack's input (B, S, d) in float32;
- ``logits(params, x, m, prec)``: the head's logits of x (B, d);
- ``layer(at, params, x, x0, m, prec, *, moe_in=None, act_dtype=None)
  -> (x_out, states)``: one layer over the residual x.  ``at`` is its
  `check.Place` (running index, group, repeat, position, layer dict);
  ``params`` the whole tree, from which the module picks the layer's
  leaves and any shared block; ``x0`` the stack's input, ``embed`` of the
  batch's tokens.  ``states`` holds what a cache keeps, under the names
  of `check.STATE_NUMBER`, and of an MoE layer ``moe_in`` (the tokens it
  routed: ``moe_in`` where given, the program's own; else its own,
  rounded to ``act_dtype`` where given) and ``experts`` (its routing);
- ``loss(m, params, tokens, labels, prec)``: the training loss;
- ``param_count(m, active)`` and ``model_flops(m, B, S, kind)``: what
  the ``mfu.*`` readers divide by.

``m`` is the configuration's ``run_as`` dict; weights come in as the
benchmark drew them and are read in float32.  The shared numerics below
(`ein`, `exact_matmuls`, `rms_norm`, `rope`, `attention`, `causal_conv`,
`ssd_scan`) are for other reference modules to import.

This module's layer is described by a plain dict (``{"mixer": "ssd" |
"attn" | "none", "mlp": "dense" | "moe" | "none", "shared_attn": bool}``):
x + mixer(norm(x)), then x + shared_attention(norm(x)) where the layer
applies it, then x + mlp(norm(x)).  It reads neither ``at``'s index nor
``x0``.

``prec`` selects the arithmetic of every product: "f32" is the reference
(under `exact_matmuls` on a card, so that no product runs in TF32);
"fp8" quantises both operands of each product to float8 e4m3 with one
scale a tensor and multiplies in float32: the control, the step below the
bfloat16 that the configurations state.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.check import places

FP8_MAX = 448.0          # largest finite float8 e4m3 value


@contextlib.contextmanager
def exact_matmuls():
    """Every float32 product in float32 for the block (no TF32 on the
    card), the process's settings restored after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def q8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale, back in float32 (a
    gradient passes through the rounding unchanged)."""
    t = t.float()
    scale = FP8_MAX / t.detach().abs().amax().clamp_min(1e-30)
    q = (t.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return t + (q - t.detach())


def ein(prec: str, eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` in float32, with fp8 operands under "fp8"."""
    if prec == "fp8":
        ops = tuple(q8(o) for o in ops)
    else:
        ops = tuple(o.float() for o in ops)
    return torch.einsum(eq, *ops)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """x / rms(x) * (1 + gamma): the stored gamma is the offset from 1."""
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (
        1.0 + gamma.float())


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (B, S, H, D) at positions 0..S-1, the two
    halves of the head rotated as pairs (i, i + D/2)."""
    S, D = x.shape[1], x.shape[-1]
    half = D // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float64,
                                         device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] \
        * freqs
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def attention(p: dict, x: torch.Tensor, heads: int, kv_heads: int,
              head_dim: int, theta: float, qk_norm: bool, eps: float,
              prec: str):
    """Causal grouped-query self-attention over x (B, S, d), one batch row
    at a time.  Returns (out (B, S, d), k, v (B, S, kv_heads, head_dim)),
    k after its norm and rotation, as a cache holds it."""
    q = ein(prec, "bsd,dhe->bshe", x, p["wq"])
    k = ein(prec, "bsd,dhe->bshe", x, p["wk"])
    v = ein(prec, "bsd,dhe->bshe", x, p["wv"])
    if qk_norm:
        q = rms_norm(q, p["q_norm"], eps)
        k = rms_norm(k, p["k_norm"], eps)
    q, k = rope(q, theta), rope(k, theta)
    B, S = x.shape[0], x.shape[1]
    g = heads // kv_heads
    mask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    outs = []
    for b in range(B):
        kb = k[b].repeat_interleave(g, dim=1)            # (S, H, D)
        vb = v[b].repeat_interleave(g, dim=1)
        s = ein(prec, "qhd,khd->hqk", q[b], kb) / math.sqrt(head_dim)
        s = s.masked_fill(~mask, float("-inf"))
        outs.append(ein(prec, "hqk,khd->qhd", torch.softmax(s, -1), vb))
    o = torch.stack(outs)
    return ein(prec, "bshe,hed->bsd", o, p["wo"]), k, v


def causal_conv(x: torch.Tensor, w: torch.Tensor):
    """Depthwise causal convolution of x (B, S, C) with w (W, C), then
    SiLU.  Returns (y, the last W-1 inputs: the state a decode resumes
    from)."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    y = sum(xp[:, i:i + S] * w[i].float() for i in range(W))
    return F.silu(y), xp[:, S:]


def ssd_scan(x, dt, A, Bm, Cm, chunk: int, prec: str):
    """The Mamba2 state-space scan, h_t = exp(dt_t A) h_{t-1} +
    dt_t x_t B_t^T, y_t = h_t C_t, in chunks of ``chunk`` steps.
    x (B, S, H, P), dt (B, S, H), A (H,), Bm / Cm (B, S, G, N).  Returns
    (y (B, S, H, P), the final state (B, H, P, N))."""
    Bs, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    L = min(chunk, S)
    pad = (-S) % L
    if pad:
        x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        Bm, Cm = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (Bm, Cm))
    nc = x.shape[1] // L
    Bh = Bm.repeat_interleave(H // G, dim=2).reshape(Bs, nc, L, H, N)
    Ch = Cm.repeat_interleave(H // G, dim=2).reshape(Bs, nc, L, H, N)
    xdt = (x * dt[..., None]).reshape(Bs, nc, L, H, P)
    cs = torch.cumsum((dt * A).reshape(Bs, nc, L, H), dim=2)
    # within a chunk: y_l = sum_{s <= l} (C_l . B_s) exp(cs_l - cs_s) xdt_s
    seg = cs.transpose(2, 3)[..., :, None] - cs.transpose(2, 3)[..., None, :]
    tri = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(seg.masked_fill(~tri, float("-inf")))
    m = ein(prec, "bclhn,bcshn->bchls", Ch, Bh) * decay
    y = ein(prec, "bchls,bcshp->bclhp", m, xdt)
    # each chunk's own state at its end, then the carry across chunks
    own = ein(prec, "bclhn,bclhp->bchpn", Bh,
              xdt * torch.exp(cs[:, :, -1:] - cs)[..., None])
    carry = torch.zeros(Bs, H, P, N, device=x.device)
    before = []
    for c in range(nc):
        before.append(carry)
        carry = carry * torch.exp(cs[:, c, -1])[..., None, None] + own[:, c]
    before = torch.stack(before, 1)                      # (B, nc, H, P, N)
    y = y + ein(prec, "bclhn,bchpn->bclhp", Ch * torch.exp(cs)[..., None],
                before)
    return y.reshape(Bs, nc * L, H, P)[:, :S], carry


def ssd_block(p: dict, x: torch.Tensor, m: dict, prec: str):
    """The Mamba2 block over x (B, S, d): in-projections, causal
    convolutions, the scan with its skip D, the SiLU(z) gate, the gated
    RMS norm and the out-projection.  Returns (out, states): the scan's
    final state and the convolutions' last inputs."""
    P = m["ssm_head_dim"]
    H = m["ssm_expand"] * m["d_model"] // P
    G, N = m["ssm_ngroups"], m["ssm_state"]
    B, S, _ = x.shape
    out = {}
    z = ein(prec, "bsd,de->bse", x, p["wz"])
    xs = ein(prec, "bsd,de->bse", x, p["wx"])
    Bp = ein(prec, "bsd,de->bse", x, p["wB"])
    Cp = ein(prec, "bsd,de->bse", x, p["wC"])
    dtp = ein(prec, "bsd,dh->bsh", x, p["wdt"])
    xs, out["conv_x"] = causal_conv(xs, p["conv_x"])
    Bp, out["conv_b"] = causal_conv(Bp, p["conv_B"])
    Cp, out["conv_c"] = causal_conv(Cp, p["conv_C"])
    A = -torch.exp(p["A_log"].float())
    dt = F.softplus(dtp + p["dt_bias"].float())
    xh = xs.reshape(B, S, H, P)
    Bp, Cp = Bp.reshape(B, S, G, N), Cp.reshape(B, S, G, N)
    rows = [ssd_scan(xh[b:b + 1], dt[b:b + 1], A, Bp[b:b + 1], Cp[b:b + 1],
                     m["ssd_chunk"], prec) for b in range(B)]
    y = torch.cat([r[0] for r in rows])
    out["ssm"] = torch.cat([r[1] for r in rows])
    y = y + p["D"].float()[:, None] * xh
    y = y.reshape(B, S, H * P) * F.silu(z)
    y = rms_norm(y, p["gate_norm"], m["norm_eps"])
    return ein(prec, "bse,ed->bsd", y, p["wo"]), out


def mlp(p: dict, x: torch.Tensor, prec: str) -> torch.Tensor:
    """SwiGLU: (SiLU(x Wg) * x Wu) Wo."""
    h = F.silu(ein(prec, "bsd,df->bsf", x, p["wi_gate"])) * \
        ein(prec, "bsd,df->bsf", x, p["wi_up"])
    return ein(prec, "bsf,fd->bsd", h, p["wo"])


def moe_capacity(n_tokens: int, m: dict) -> int:
    """Slots an expert holds: every token up to 512 tokens, else
    ceil(N k / E * capacity_factor); what lies beyond is dropped."""
    if n_tokens <= 512:
        return n_tokens
    return math.ceil(n_tokens * m["experts_per_token"] / m["num_experts"]
                     * m["capacity_factor"])


def moe_route(x: torch.Tensor, router: torch.Tensor, k: int):
    """Softmax routing over x (N, d): the k most probable experts (ties to
    the lower index), their probabilities renormalised to sum to one.
    The router's product is taken in float64."""
    probs = torch.softmax((x.double() @ router.double()).float(), dim=-1)
    gates, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = gates[:, :k], experts[:, :k]
    return gates / gates.sum(-1, keepdim=True).clamp_min(1e-9), experts


def moe(p: dict, x: torch.Tensor, m: dict, prec: str, route_in=None):
    """Routed SwiGLU experts over x (B, S, d).  Assignments are taken in
    token order, a token's k choices in order of probability; an expert
    keeps the first ``moe_capacity`` assignments it receives and drops
    the rest (a dropped assignment adds nothing).  The routing is taken
    from ``route_in`` where it is given (the same tokens as the program
    held them), else from x.  Returns (out, experts (N, k))."""
    B, S, d = x.shape
    E, k = m["num_experts"], m["experts_per_token"]
    xf = x.reshape(B * S, d)
    src = xf if route_in is None else route_in.reshape(B * S, d)
    gates, experts = moe_route(src, p["router"], k)
    cap = moe_capacity(B * S, m)
    flat = experts.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=E)
    first = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(flat)
    rank[order] = torch.arange(flat.numel(), device=x.device) - \
        first[flat[order]]
    keep = rank < cap
    out = torch.zeros(B * S, d, device=x.device)
    tok = torch.arange(B * S, device=x.device).repeat_interleave(k)
    gate = gates.reshape(-1)
    for e in range(E):
        sel = (flat == e) & keep
        rows = tok[sel]
        if not len(rows):
            continue
        pe = {n: p[n][e] for n in ("wi_gate", "wi_up", "wo")}
        y = mlp(pe, xf[rows][None], prec)[0]
        out.index_add_(0, rows, y * gate[sel][:, None])
    return out.reshape(B, S, d), experts


def layer_leaves(params: dict, at) -> dict:
    """The leaves of the layer at ``at`` (its repeat's slice)."""
    def pick(t):
        return {k: pick(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[at.repeat]
    return pick(params["decoder"][f"g{at.group}"][f"L{at.position}"])


def layer(at, params: dict, x: torch.Tensor, x0: torch.Tensor, m: dict,
          prec: str, *, moe_in=None, act_dtype=None):
    """One layer over the residual x (B, S, d), as the configuration runs
    it (the contract above; ``x0`` and ``at.index`` are not read)."""
    return block(at.spec, layer_leaves(params, at), params.get("shared_attn"),
                 x, m, prec, moe_in=moe_in, act_dtype=act_dtype)


def block(lspec: dict, p: dict, shared: dict, x: torch.Tensor, m: dict,
          prec: str, moe_in=None, act_dtype=None):
    """`layer` on one layer's leaves ``p`` and the shared attention's
    ``shared``: x + mixer(norm(x)), then x + shared_attention(norm(x))
    where the layer applies it, then x + mlp(norm(x)).  Returns (x,
    states) with the states a cache keeps: ``ssm`` / ``conv_*`` of the
    SSD mixer, ``k`` / ``v`` of the attention mixer, ``shared_k`` /
    ``shared_v`` of the shared attention; and of an MoE, ``moe_in`` and
    ``experts``."""
    eps = m["norm_eps"]
    x = x.float()
    states = {}
    if lspec["mixer"] == "ssd":
        h, states = ssd_block(p["ssd"], rms_norm(x, p["ln_mixer"], eps), m,
                              prec)
        x = x + h
    elif lspec["mixer"] == "attn":
        h, states["k"], states["v"] = attention(
            p["attn"], rms_norm(x, p["ln_mixer"], eps), m["num_heads"],
            m["num_kv_heads"], m["head_dim"], m["rope_theta"],
            m["qk_norm"], eps, prec)
        x = x + h
    if lspec.get("shared_attn"):
        h, states["shared_k"], states["shared_v"] = attention(
            shared["attn"], rms_norm(x, shared["ln"], eps),
            m["shared_attn_heads"], m["shared_attn_kv_heads"],
            m["head_dim"], m["rope_theta"], False, eps, prec)
        x = x + h
    if lspec["mlp"] == "dense":
        x = x + mlp(p["mlp"], rms_norm(x, p["ln_mlp"], eps), prec)
    elif lspec["mlp"] == "moe":
        h = rms_norm(x, p["ln_mlp"], eps)
        if moe_in is None:
            moe_in = h if act_dtype is None else h.to(act_dtype)
        y, states["experts"] = moe(p["moe"], h, m, prec, route_in=moe_in)
        states["moe_in"] = moe_in
        x = x + y
    return x, states


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows of ``tokens``, in float32."""
    return params["embed"]["embedding"].float()[tokens.long()]


def logits(params: dict, x: torch.Tensor, m: dict, prec: str
           ) -> torch.Tensor:
    """The head's logits of x (B, d): the final RMS norm, then the
    unembedding."""
    p = params["embed"]
    return ein(prec, "bd,dv->bv", rms_norm(x, p["final_norm"], m["norm_eps"]),
               p["lm_head"])


# ------------------------------------------------------------------ training
def moe_aux(p: dict, h: torch.Tensor, m: dict) -> torch.Tensor:
    """The load-balance loss of one MoE layer over its input h:
    E * sum_e f_e P_e / k, f_e the share of assignments to expert e and
    P_e its mean router probability (Switch Transformer)."""
    E, k = m["num_experts"], m["experts_per_token"]
    hf = h.reshape(-1, h.shape[-1])
    probs = torch.softmax((hf.double() @ p["router"].double()).float(), -1)
    _, experts = moe_route(hf.detach(), p["router"].detach(), k)
    f = torch.bincount(experts.reshape(-1), minlength=E).float() / hf.shape[0]
    return E * torch.sum(f * probs.mean(0)) / k


def head_nll(params: dict, x: torch.Tensor, labels: torch.Tensor, m: dict,
             prec: str) -> torch.Tensor:
    """Mean token NLL of ``labels`` under the head's logits of the last
    residual x (B, S, d), a row at a time."""
    p = params["embed"]
    h = rms_norm(x, p["final_norm"], m["norm_eps"])
    nll = 0.0
    for b in range(h.shape[0]):
        lg = ein(prec, "sd,dv->sv", h[b], p["lm_head"])
        nll = nll + F.cross_entropy(lg, labels[b].long(), reduction="sum")
    return nll / labels.numel()


def loss(m: dict, params: dict, tokens: torch.Tensor, labels: torch.Tensor,
         prec: str = "f32") -> torch.Tensor:
    """Mean token NLL of ``labels`` plus ``router_aux_coef`` times the
    MoE layers' load-balance losses; each layer recomputed in the
    backward (`torch.utils.checkpoint`) so that it fits."""
    x = embed(params, tokens)
    aux = torch.zeros((), device=x.device)
    shared = params.get("shared_attn")
    for at in places(m):
        ls, p = at.spec, layer_leaves(params, at)

        def body(x, p=p, ls=ls):
            if ls["mlp"] != "moe":
                return block(ls, p, shared, x, m, prec)[0], \
                    torch.zeros((), device=x.device)
            mid = block(dict(ls, mlp="none"), p, shared, x, m, prec)[0]
            h = rms_norm(mid, p["ln_mlp"], m["norm_eps"])
            y, _ = moe(p["moe"], h, m, prec)
            return mid + y, moe_aux(p["moe"], h, m)
        x, a = checkpoint(body, x, use_reentrant=False)
        aux = aux + a
    return head_nll(params, x, labels, m, prec) + \
        m.get("router_aux_coef", 0.0) * aux


# ------------------------------------------------------------------ counts
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
    specs = [at.spec for at in places(m)]
    n += sum(layer_params(m, ls, active) for ls in specs)
    if any(ls.get("shared_attn") for ls in specs):
        n += d + attn_params(m, m["shared_attn_heads"],
                             m["shared_attn_kv_heads"], m["qk_norm"])
    return n


def _attn_layers(m: dict) -> int:
    return sum((at.spec["mixer"] == "attn") + bool(at.spec.get("shared_attn"))
               for at in places(m))


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
