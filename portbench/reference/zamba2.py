"""The plain reference of the published Zamba2 block (Zyphra/Zamba2-7B and
-7B-Instruct, hf config.json; the forward of transformers'
``Zamba2ForCausalLM``): every layer written out in float32 PyTorch from
its equations, with no kernel, cache or batching of the program under
test, to the contract in `reference/ops.py`.  It imports nothing of that
program; the shared numerics are `ops`' own.

A model of ``m["groups"]``: Mamba2 layers, x + mamba(norm(x)), and at each
layer whose dict has ``shared_attn`` (the published ``hybrid_layer_ids``)

    x + mamba(norm(x + linear_i(block_{i mod n}(x, x0, i))))

where i is the layer's application number (the layers before it that
apply a block, counted from 0 in the configuration's own stack), x0 the
stack's input (the embedding of the tokens), linear_i the layer's own
d x d linear, and n the number of shared blocks.  A block:

    mlp_i(norm2(attention(norm1(concat(x, x0)))))

with no residual inside: attention from 2 d to d over heads of
``head_dim`` with the scores scaled by (head_dim / 2)^-1/2 and rope over
every dimension of the head, no qk-norm; the MLP gated by exact-erf GELU,
its gate and up projections each adding x A_i G_i / x A_i U_i, the
application's own rank-r adapter.  Mamba2: in-projections to z, x, B, C
(``ssm_ngroups`` groups of ``ssm_state``) and dt; a depthwise causal
convolution with a bias on each of x, B and C, then SiLU; the scan with
its skip D; the SiLU(z) gate; the RMS norm taken over each group's
d_inner / G channels alone; the out-projection.  Every norm has
``norm_eps``; the head is the embedding's transpose where the tree has
no ``lm_head`` (tied, `Zamba2Config`'s default).

Departures from the published model, all of the weights' layout and
draws, none of the arithmetic: the tree is the program's, so every RMS
norm's weight is stored as its offset from 1 (the published weight is 1 +
the stored value), the in-projection and the convolution are split into
their x / B / C / z / dt parts, each conv's bias is a (1, C) row, and
A_log, D and dt_bias are drawn by the program's spec (0, 1 and 0); the
weights are random (`weights.py`); dt is not floored at
``time_step_min`` (transformers' torch fallback floors it at 0.001, the
published kernel path with ``time_step_limit`` None does not).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.check import places
from portbench.reference.ops import attention, ein, embed, rms_norm, ssd_scan


# ------------------------------------------------------------------ layers
def causal_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor):
    """Depthwise causal convolution of x (B, S, C) with w (W, C), plus the
    bias (1, C), then SiLU (`ops.causal_conv` has no bias).  Returns (y,
    the last W-1 inputs: the state a decode resumes from)."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    y = sum(xp[:, i:i + S] * w[i].float() for i in range(W))
    return F.silu(y + bias.float()), xp[:, S:]


def mamba(p: dict, x: torch.Tensor, m: dict, prec: str):
    """The Mamba2 mixer over x (B, S, d) (already normed).  Returns (out,
    states): the scan's final state and the convolutions' last inputs."""
    P, G, N = m["ssm_head_dim"], m["ssm_ngroups"], m["ssm_state"]
    H = m["ssm_expand"] * m["d_model"] // P
    B, S, _ = x.shape
    out = {}
    z = ein(prec, "bsd,de->bse", x, p["wz"])
    xs, out["conv_x"] = causal_conv(ein(prec, "bsd,de->bse", x, p["wx"]),
                                    p["conv_x"], p["conv_x_bias"])
    Bp, out["conv_b"] = causal_conv(ein(prec, "bsd,de->bse", x, p["wB"]),
                                    p["conv_B"], p["conv_B_bias"])
    Cp, out["conv_c"] = causal_conv(ein(prec, "bsd,de->bse", x, p["wC"]),
                                    p["conv_C"], p["conv_C_bias"])
    dt = F.softplus(ein(prec, "bsd,dh->bsh", x, p["wdt"])
                    + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    xh = xs.reshape(B, S, H, P)
    Bp, Cp = Bp.reshape(B, S, G, N), Cp.reshape(B, S, G, N)
    rows = [ssd_scan(xh[b:b + 1], dt[b:b + 1], A, Bp[b:b + 1], Cp[b:b + 1],
                     m["ssd_chunk"], prec) for b in range(B)]
    y = torch.cat([r[0] for r in rows]) + p["D"].float()[:, None] * xh
    out["ssm"] = torch.cat([r[1] for r in rows])
    y = y.reshape(B, S, H * P) * F.silu(z)
    # the gated norm over each group's channels alone
    y = rms_norm(y.reshape(B, S, G, -1), p["gate_norm"].reshape(G, -1),
                 m["norm_eps"]).reshape(B, S, H * P)
    return ein(prec, "bse,ed->bsd", y, p["wo"]), out


def shared_block(blk: dict, p: dict, x: torch.Tensor, x0: torch.Tensor,
                 m: dict, prec: str):
    """One application of a shared block (its leaves ``blk``) with the
    layer's adapter and linear (``p``): linear(mlp(norm2(attention(
    norm1(concat(x, x0)))))).  Returns (out, k, v), k after its rotation,
    as a cache holds it."""
    eps = m["norm_eps"]
    # a program that ran a layer on fewer rows than the batch (a loss over
    # part of it) ran the batch's first rows
    x0 = x0[:x.shape[0]]
    h = rms_norm(torch.cat([x.float(), x0.float()], -1), blk["ln"], eps)
    # `ops.attention` reads its head_dim for the scale alone: head_dim / 2
    # gives the published (head_dim / 2)^-1/2
    h, k, v = attention(blk["attn"], h, m["shared_attn_heads"],
                        m["shared_attn_kv_heads"], m["head_dim"] / 2,
                        m["rope_theta"], False, eps, prec)
    h = rms_norm(h, blk["ln_mlp"], eps)
    ad, mlp = p["adapter"], blk["mlp"]
    ha = ein(prec, "bsd,dr->bsr", h, ad["a"])
    gate = ein(prec, "bsd,df->bsf", h, mlp["wi_gate"]) + \
        ein(prec, "bsr,rf->bsf", ha, ad["gate"])
    up = ein(prec, "bsd,df->bsf", h, mlp["wi_up"]) + \
        ein(prec, "bsr,rf->bsf", ha, ad["up"])
    h = ein(prec, "bsf,fd->bsd", F.gelu(gate) * up, mlp["wo"])
    return ein(prec, "bsd,de->bse", h, p["shared_lin"]), k, v


def application(m: dict, index: int) -> int:
    """The application number of the layer at running index ``index``:
    the layers before it that apply a shared block."""
    return sum(bool(at.spec.get("shared_attn")) for at in places(m)
               if at.index < index)


def layer_leaves(params: dict, at) -> dict:
    """The leaves of the layer at ``at`` (its repeat's slice)."""
    return pick(params["decoder"][f"g{at.group}"][f"L{at.position}"],
                at.repeat)


def pick(tree, i: int):
    return {k: pick(v, i) for k, v in tree.items()} \
        if isinstance(tree, dict) else tree[i]


def layer(at, params: dict, x: torch.Tensor, x0: torch.Tensor, m: dict,
          prec: str, *, moe_in=None, act_dtype=None):
    """One layer over the residual x (B, S, d), the stack's input ``x0``
    (the contract in `reference/ops.py`): (x_out, states) with ``ssm`` /
    ``conv_*`` of the Mamba2 mixer and, where the layer applies a shared
    block, its ``shared_k`` / ``shared_v``."""
    p = layer_leaves(params, at)
    x = x.float()
    states = {}
    mixer_in = x
    if at.spec.get("shared_attn"):
        blocks = params["shared_attn"]
        blk = pick(blocks, application(m, at.index) % blocks["ln"].shape[0])
        h, states["shared_k"], states["shared_v"] = shared_block(
            blk, p, x, x0, m, prec)
        mixer_in = x + h
    h, mixer_states = mamba(p["ssd"], rms_norm(mixer_in, p["ln_mixer"],
                                               m["norm_eps"]), m, prec)
    states.update(mixer_states)
    return x + h, states


def head(params: dict) -> torch.Tensor:
    """The head's (d, V) weight: ``lm_head``, or the embedding's
    transpose where the tree ties them."""
    p = params["embed"]
    return p["lm_head"] if "lm_head" in p else p["embedding"].T


def logits(params: dict, x: torch.Tensor, m: dict, prec: str
           ) -> torch.Tensor:
    """The head's logits of x (B, d): the final RMS norm, then the head."""
    return ein(prec, "bd,dv->bv", rms_norm(x, params["embed"]["final_norm"],
                                           m["norm_eps"]), head(params))


# ------------------------------------------------------------------ training
def loss(m: dict, params: dict, tokens: torch.Tensor, labels: torch.Tensor,
         prec: str = "f32") -> torch.Tensor:
    """Mean token NLL of ``labels``, each layer recomputed in the backward
    (`torch.utils.checkpoint`) so that it fits; the head's logits a row at
    a time."""
    x0 = embed(params, tokens)
    x = x0
    for at in places(m):
        x = checkpoint(lambda x, at=at: layer(at, params, x, x0, m, prec)[0],
                       x, use_reentrant=False)
    h = rms_norm(x, params["embed"]["final_norm"], m["norm_eps"])
    w, nll = head(params), 0.0
    for b in range(h.shape[0]):
        lg = ein(prec, "sd,dv->sv", h[b], w)
        nll = nll + F.cross_entropy(lg, labels[b].long(), reduction="sum")
    return nll / labels.numel()


# ------------------------------------------------------------------ counts
def mamba_params(m: dict) -> int:
    """One Mamba2 layer with its input norm: the in-projection (z, x, B,
    C, dt), the convolution's weights and biases, A_log, D, dt_bias, the
    gated norm, the out-projection."""
    d, di = m["d_model"], m["ssm_expand"] * m["d_model"]
    h = di // m["ssm_head_dim"]
    conv = di + 2 * m["ssm_ngroups"] * m["ssm_state"]
    w = m["ssm_conv_width"]
    return d + d * (di + conv + h) + (w + 1) * conv + 3 * h + di + di * d


def block_params(m: dict) -> int:
    """One shared block: its two norms, attention from 2 d to d, and the
    gated MLP."""
    d, hd, f = m["d_model"], m["head_dim"], m["d_ff"]
    hq, hk = m["shared_attn_heads"], m["shared_attn_kv_heads"]
    return 2 * d + 2 * d * (hq + 2 * hk) * hd + hq * hd * d + d + 3 * d * f


def application_params(m: dict) -> int:
    """What each application adds of its own: the adapter and the linear."""
    d, r, f = m["d_model"], m["shared_adapter_rank"], m["d_ff"]
    return d * r + 2 * r * f + d * d


def counts(m: dict):
    """(layers, applications, shared blocks) of the configuration."""
    specs = [at.spec for at in places(m)]
    return len(specs), sum(bool(s.get("shared_attn")) for s in specs), \
        m["shared_blocks"]


def param_count(m: dict, active: bool = False) -> int:
    """Every parameter of the model: the embedding (tied to the head, so
    counted once), the final norm, the Mamba2 layers, the shared blocks
    once, and each application's adapter and linear."""
    L, apps, blocks = counts(m)
    d, V = m["d_model"], m["vocab_size"]
    head_extra = 0 if m.get("tie_embeddings", True) else V * d
    return V * d + head_extra + d + L * mamba_params(m) + \
        blocks * block_params(m) + apps * application_params(m)


def model_flops(m: dict, B: int, S: int, kind: str) -> float:
    """Model FLOP of one step over B sequences of S tokens: 2 N T for a
    prefill and 6 N T for a train step, N the parameters a token passes
    through (each Mamba2 layer, each of the applications with its block,
    adapter and linear, and the head; not the embedding's lookup), plus
    causal attention, 4 B (S^2 / 2) H D an application, three times that
    in training.  The scan's own work and any recompute are not
    counted."""
    L, apps, _ = counts(m)
    d, V = m["d_model"], m["vocab_size"]
    n = L * mamba_params(m) + apps * (block_params(m) +
                                      application_params(m)) + V * d + d
    attn = 4.0 * B * (S * S / 2) * m["shared_attn_heads"] * m["head_dim"] \
        * apps
    if kind == "train":
        return 6.0 * n * B * S + 3.0 * attn
    if kind == "prefill":
        return 2.0 * n * B * S + attn
    raise ValueError(f"no model FLOP for a {kind!r} step")
