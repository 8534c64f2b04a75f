"""Model assembly: layer groups, parameter/cache spec trees, forward passes.

Counterpart of `repro.models.model`.  The model is a sequence of layer
groups (see `configs.base`); each group's parameters and caches are stacked
on a leading repeat axis, and the forward pass loops over that axis (the
reference scans it).  Parameters and caches are nested dicts of tensors
keyed by the reference's `ParamSpec` paths.

An encoder-decoder model (``cfg.is_encdec``) runs its encoder groups
bidirectionally over ``batch["enc_embeds"]`` (`encode`); each decoder
layer's cross attention projects the encoder output to k/v, which prefill
writes into the ``cross_k`` / ``cross_v`` caches and decode reads back (a
decode batch carries no ``enc_embeds``).

`prefill` and `decode_step` update the caches they are given in place and
return them with the new ``index``.  `loss_fn` is the train objective; in
train mode with ``cfg.remat == "full"`` each repeat's layers run under
activation checkpointing (the reference's `jax.checkpoint` of its scan
body), so the backward recomputes them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import GroupSpec, LayerSpec, ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.parallel.sharding import (ParamSpec, tree_leaves_with_path,
                                           tree_map_specs)

_REMAT_DOTS = ("remat='dots' (save the matmul outputs, recompute the rest) "
               "is not ported (ROADMAP queue 2, after parity); use 'full' or "
               "'none'")


# --------------------------------------------------------------------------- #
# Param specs
# --------------------------------------------------------------------------- #
def layer_param_specs(cfg: ModelConfig, lspec: LayerSpec,
                      decoder_cross: bool = False) -> dict:
    d: Dict[str, Any] = {}
    if lspec.mixer in ("attn", "attn_local"):
        d["ln_mixer"] = L.norm_spec(cfg.d_model)
        d["attn"] = attn_lib.attn_specs(cfg)
    elif lspec.mixer == "ssd":
        d["ln_mixer"] = L.norm_spec(cfg.d_model)
        d["ssd"] = ssm_lib.ssd_specs(cfg)
    if decoder_cross:
        d["ln_cross"] = L.norm_spec(cfg.d_model)
        d["cross"] = attn_lib.cross_attn_specs(cfg)
    if lspec.mlp == "dense":
        d["ln_mlp"] = L.norm_spec(cfg.d_model)
        d["mlp"] = L.mlp_specs(cfg)
    elif lspec.mlp == "moe":
        d["ln_mlp"] = L.norm_spec(cfg.d_model)
        d["moe"] = moe_lib.moe_specs(cfg)
    return d


def _stack(tree, repeat: int):
    return tree_map_specs(
        lambda s: ParamSpec((repeat,) + s.shape, (None,) + s.logical,
                            s.dtype, s.init, s.scale), tree)


def group_param_specs(cfg: ModelConfig, g: GroupSpec,
                      decoder_cross: bool = False) -> dict:
    per_layer = {f"L{p}": layer_param_specs(cfg, ls, decoder_cross)
                 for p, ls in enumerate(g.layers)}
    return _stack(per_layer, g.repeat)


def _shared_cfg(cfg: ModelConfig) -> ModelConfig:
    return cfg.replace(num_heads=cfg.shared_attn_heads or cfg.num_heads,
                       num_kv_heads=cfg.shared_attn_kv_heads
                       or cfg.num_kv_heads)


def shared_attn_specs(cfg: ModelConfig) -> dict:
    sub = _shared_cfg(cfg)
    return {"ln": L.norm_spec(cfg.d_model),
            "attn": attn_lib.attn_specs(sub, heads=sub.num_heads,
                                        kv_heads=sub.num_kv_heads)}


def model_param_specs(cfg: ModelConfig) -> dict:
    tree: Dict[str, Any] = {"embed": L.embed_specs(cfg)}
    tree["decoder"] = {f"g{i}": group_param_specs(cfg, g, cfg.is_encdec)
                       for i, g in enumerate(cfg.groups)}
    if cfg.is_encdec:
        tree["encoder"] = {f"g{i}": group_param_specs(cfg, g, False)
                           for i, g in enumerate(cfg.encoder_groups)}
        tree["encoder"]["enc_norm"] = L.norm_spec(cfg.d_model)
    if any(ls.shared_attn for g in cfg.groups for ls in g.layers):
        tree["shared_attn"] = shared_attn_specs(cfg)
    return tree


def count_params(cfg: ModelConfig, include_embed: bool = True,
                 active_only: bool = False) -> int:
    total = 0
    for path, s in tree_leaves_with_path(model_param_specs(cfg)):
        keys = path.split(".")
        n = 1
        for dim in s.shape:
            n *= int(dim)
        if not include_embed and ("embedding" in keys or "lm_head" in keys):
            continue
        if active_only and "moe" in keys and keys[-1] in ("wi_gate", "wi_up",
                                                         "wo"):
            # routed experts: scale by activated fraction
            n = n * max(cfg.experts_per_token, 1) // max(cfg.num_experts, 1)
        total += n
    return total


# --------------------------------------------------------------------------- #
# Cache specs
# --------------------------------------------------------------------------- #
def layer_cache_specs(cfg: ModelConfig, lspec: LayerSpec, batch: int,
                      cache_len: int, src_len: int = 0,
                      decoder_cross: bool = False) -> dict:
    d: Dict[str, Any] = {}
    if lspec.mixer == "attn":
        d.update(attn_lib.cache_specs(cfg, batch, cache_len))
    elif lspec.mixer == "attn_local":
        d.update(attn_lib.cache_specs(cfg, batch,
                                      min(cache_len, cfg.window_size)))
    elif lspec.mixer == "ssd":
        d.update(ssm_lib.ssd_cache_specs(cfg, batch))
    if lspec.shared_attn:
        kh = cfg.shared_attn_kv_heads or cfg.num_kv_heads
        cs = attn_lib.cache_specs(cfg, batch, cache_len, kv_heads=kh)
        d["shared_k"] = cs["k"]
        d["shared_v"] = cs["v"]
    if decoder_cross:
        d["cross_k"] = ParamSpec((batch, src_len, cfg.num_kv_heads,
                                  cfg.head_dim),
                                 ("batch", "kv_seq", "kv_heads", None),
                                 dtype=cfg.act_dtype, init="zeros")
        d["cross_v"] = d["cross_k"]
    return d


def cache_specs_tree(cfg: ModelConfig, batch: int, cache_len: int,
                     src_len: int = 0) -> dict:
    tree: Dict[str, Any] = {"decoder": {}}
    for i, g in enumerate(cfg.groups):
        per_layer = {f"L{p}": layer_cache_specs(cfg, ls, batch, cache_len,
                                                src_len, cfg.is_encdec)
                     for p, ls in enumerate(g.layers)}
        tree["decoder"][f"g{i}"] = _stack(per_layer, g.repeat)
    tree["index"] = ParamSpec((batch,), ("batch",), dtype=torch.int32,
                              init="zeros")
    return tree


# --------------------------------------------------------------------------- #
# Forward
# --------------------------------------------------------------------------- #
def apply_layer(cfg: ModelConfig, lspec: LayerSpec, p: dict, x: torch.Tensor,
                aux: torch.Tensor, *, shared_params=None, mode: str,
                positions=None, cache=None, index=None, enc_kv=None,
                causal: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[dict]]:
    new_cache: Dict[str, Any] = {}
    if lspec.mixer in ("attn", "attn_local"):
        h = L.rms_norm(x, p["ln_mixer"], cfg.norm_eps)
        sub_cache = ({"k": cache["k"], "v": cache["v"]}
                     if cache and "k" in cache else None)
        h, nc = attn_lib.attention_block(
            p["attn"], h, cfg, local=(lspec.mixer == "attn_local"), mode=mode,
            positions=positions, cache=sub_cache, index=index, causal=causal)
        x = x + h
        if nc:
            new_cache.update(nc)
    elif lspec.mixer == "ssd":
        h = L.rms_norm(x, p["ln_mixer"], cfg.norm_eps)
        sub_cache = ({k: cache[k] for k in ("ssm", "conv_x", "conv_b",
                                            "conv_c")}
                     if cache and "ssm" in cache else None)
        h, nc = ssm_lib.ssd_block(p["ssd"], h, cfg, mode=mode,
                                  cache=sub_cache)
        x = x + h
        if nc:
            new_cache.update(nc)

    if lspec.shared_attn and shared_params is not None:
        h = L.rms_norm(x, shared_params["ln"], cfg.norm_eps)
        scfg = _shared_cfg(cfg).replace(qk_norm=False)
        sub_cache = ({"k": cache["shared_k"], "v": cache["shared_v"]}
                     if cache and "shared_k" in cache else None)
        h, nc = attn_lib.attention_block(
            shared_params["attn"], h, scfg, local=False, mode=mode,
            positions=positions, cache=sub_cache, index=index)
        x = x + h
        if nc:
            new_cache["shared_k"] = nc["k"]
            new_cache["shared_v"] = nc["v"]

    if enc_kv is not None and "cross" in p:
        h = L.rms_norm(x, p["ln_cross"], cfg.norm_eps)
        x = x + attn_lib.cross_attention_block(p["cross"], h, enc_kv, cfg)

    if lspec.mlp == "dense":
        h = L.rms_norm(x, p["ln_mlp"], cfg.norm_eps)
        x = x + L.mlp_apply(p["mlp"], h)
    elif lspec.mlp == "moe":
        h = L.rms_norm(x, p["ln_mlp"], cfg.norm_eps)
        h, a = moe_lib.moe_block(p["moe"], h, cfg)
        x = x + h
        aux = aux + a

    return x, aux, (new_cache or None)


def _index_tree(tree, r: int):
    if isinstance(tree, dict):
        return {k: _index_tree(v, r) for k, v in tree.items()}
    return tree[r]


def _layer_enc_kv(cfg: ModelConfig, lp: dict, lc: Optional[dict], enc_out,
                  mode: str):
    """A decoder layer's cross-attention (k, v): from its cache in decode,
    else projected from the encoder output; None without cross attention."""
    if enc_out is None or "cross" not in lp:
        return None
    if mode == "decode" and lc is not None and "cross_k" in lc:
        return lc["cross_k"], lc["cross_v"]
    return attn_lib.encode_cross_kv(lp["cross"], enc_out, cfg)


def _write_cross(lc: dict, enc_kv) -> None:
    """Prefill: the cross k/v into the layer's ``cross_k`` / ``cross_v``
    caches, in place (their length is the source length they were made
    for)."""
    for name, new in zip(("cross_k", "cross_v"), enc_kv):
        if lc[name].shape != new.shape:
            raise ValueError(f"{name} cache {tuple(lc[name].shape)} does not "
                             f"fit the encoder output's {tuple(new.shape)}: "
                             "make the caches with src_len = its length")
        lc[name].copy_(new)


def run_groups(cfg: ModelConfig, groups, params: dict, x: torch.Tensor, *,
               mode: str, positions=None, caches=None, index=None,
               shared_params=None, enc_out=None, causal: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor, Optional[dict]]:
    """Run all layer groups, repeat by repeat.  Returns (x, aux, caches):
    the caches given, updated in place, or None without caches.
    ``enc_out`` (B, S_src, d) feeds the decoder layers' cross attention."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = mode == "train" and cfg.remat != "none"
    if remat and cfg.remat != "full":
        raise NotImplementedError(_REMAT_DOTS)
    for gi, g in enumerate(groups):
        gp = params[f"g{gi}"]
        gc = caches[f"g{gi}"] if caches is not None else None
        for r in range(g.repeat):
            p_slice = _index_tree(gp, r)
            if remat:
                x, aux = checkpoint(_remat_body(), cfg, g.layers, p_slice, x,
                                    aux, shared_params, positions, enc_out,
                                    causal, use_reentrant=False)
                continue
            c_slice = _index_tree(gc, r) if gc is not None else None
            for pidx, ls in enumerate(g.layers):
                key = f"L{pidx}"
                lc = c_slice[key] if c_slice is not None else None
                enc_kv = _layer_enc_kv(cfg, p_slice[key], lc, enc_out, mode)
                x, aux, nc = apply_layer(
                    cfg, ls, p_slice[key], x, aux,
                    shared_params=shared_params, mode=mode,
                    positions=positions, cache=lc, index=index,
                    enc_kv=enc_kv, causal=causal)
                if (lc is not None and "cross_k" in lc and enc_kv is not None
                        and mode == "prefill"):
                    _write_cross(lc, enc_kv)
                if lc is not None and nc:
                    for name, new in nc.items():
                        dst = lc[name]            # a view into the stack
                        if new.data_ptr() != dst.data_ptr():
                            dst.copy_(new)
    return x, aux, caches


def _remat_body():
    """`_repeat_body` for one checkpointed repeat: its first call is the
    forward; a later call is the recompute that the backward triggers,
    run under a ``remat_recompute`` profiler range so that a profile can
    tell its kernels from the backward node that unpacked the input."""
    calls = [0]

    def body(*args):
        calls[0] += 1
        if calls[0] == 1:
            return _repeat_body(*args)
        with torch.profiler.record_function("remat_recompute"):
            return _repeat_body(*args)
    return body


def _repeat_body(cfg: ModelConfig, layers, p_slice: dict, x: torch.Tensor,
                 aux: torch.Tensor, shared_params, positions, enc_out,
                 causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """One repeat of a group's layers in train mode (no caches): the unit
    that activation checkpointing saves the input of and recomputes."""
    for pidx, ls in enumerate(layers):
        lp = p_slice[f"L{pidx}"]
        x, aux, _ = apply_layer(
            cfg, ls, lp, x, aux, shared_params=shared_params, mode="train",
            positions=positions, causal=causal,
            enc_kv=_layer_enc_kv(cfg, lp, None, enc_out, "train"))
    return x, aux


# --------------------------------------------------------------------------- #
# Top-level entry points
# --------------------------------------------------------------------------- #
def _inputs_to_x(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    if "embeds" in batch:
        return batch["embeds"].to(cfg.act_dtype)
    return L.embed_tokens(params["embed"], batch["tokens"], cfg)


def _positions(cfg: ModelConfig, batch: dict, B: int, S: int, device,
               index=None) -> torch.Tensor:
    if "positions" in batch:
        return batch["positions"]
    if index is not None:
        pos = attn_lib.per_seq(index, B, device)[:, None]
    else:
        pos = torch.broadcast_to(torch.arange(S, device=device), (B, S))
    if cfg.mrope:
        pos = torch.broadcast_to(pos[None], (3,) + tuple(pos.shape))
    return pos


def encode(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """The encoder over ``batch["enc_embeds"]`` (B, S_src, d): its groups
    without a causal mask, then ``enc_norm``."""
    x = batch["enc_embeds"].to(cfg.act_dtype)
    B, S = x.shape[0], x.shape[1]
    pos = torch.broadcast_to(torch.arange(S, device=x.device), (B, S))
    x, _, _ = run_groups(cfg, cfg.encoder_groups, params["encoder"], x,
                         mode="train", positions=pos, causal=False)
    return L.rms_norm(x, params["encoder"]["enc_norm"], cfg.norm_eps)


def backbone(cfg: ModelConfig, params: dict, batch: dict, *,
             mode: str = "train", caches=None, index=None):
    """Everything up to (but excluding) the LM head.  An encoder-decoder
    model encodes ``enc_embeds`` first; a decode batch without them reads
    the cross caches, and its ``enc_out`` is a (B, 1, d) zero stand-in."""
    enc_out = None
    if cfg.is_encdec:
        if mode != "decode" or "enc_embeds" in batch:
            enc_out = encode(cfg, params, batch)
        x = L.embed_tokens(params["embed"], batch["tokens"], cfg)
        if enc_out is None:
            enc_out = torch.zeros((x.shape[0], 1, cfg.d_model),
                                  dtype=cfg.act_dtype, device=x.device)
    else:
        x = _inputs_to_x(cfg, params, batch)
    B, S = x.shape[0], x.shape[1]
    positions = _positions(cfg, batch, B, S, x.device,
                           index if mode == "decode" else None)
    dec_caches = caches["decoder"] if caches is not None else None
    x, aux, new_dec = run_groups(cfg, cfg.groups, params["decoder"], x,
                                 mode=mode, positions=positions,
                                 caches=dec_caches, index=index,
                                 shared_params=params.get("shared_attn"),
                                 enc_out=enc_out, causal=True)
    new_caches = None
    if new_dec is not None:
        if index is not None:   # decode: advance each sequence's position
            new_idx = (attn_lib.per_seq(index, B, x.device)
                       + S).to(torch.int32)
        else:                    # prefill: every sequence sits at S
            new_idx = torch.full((B,), S, dtype=torch.int32, device=x.device)
        new_caches = {"decoder": new_dec, "index": new_idx}
    return x, aux, new_caches


def forward(cfg: ModelConfig, params: dict, batch: dict, *,
            mode: str = "train", caches=None, index=None
            ) -> Tuple[torch.Tensor, torch.Tensor, Optional[dict]]:
    """Returns (logits, aux_loss, new_caches)."""
    x, aux, new_caches = backbone(cfg, params, batch, mode=mode,
                                  caches=caches, index=index)
    if mode == "prefill":
        # only the last position's logits are needed to start decoding
        x = x[:, -1:]
    logits = L.lm_logits(params["embed"], x, cfg)
    return logits, aux, new_caches


def loss_fn(cfg: ModelConfig, params: dict, batch: dict
            ) -> Tuple[torch.Tensor, dict]:
    """The train objective: mean token NLL (masked by ``loss_mask`` when
    the batch has one) plus the router's aux loss.  Returns (loss,
    {"loss", "nll", "aux"})."""
    x, aux, _ = backbone(cfg, params, batch, mode="train")
    nll = L.lm_head_loss(params["embed"], x, batch["labels"], cfg,
                         batch.get("loss_mask"))
    loss = nll + cfg.router_aux_coef * aux
    return loss, {"loss": loss, "nll": nll, "aux": aux}


def prefill(cfg: ModelConfig, params: dict, batch: dict, caches
            ) -> Tuple[torch.Tensor, dict]:
    logits, _, new_caches = forward(cfg, params, batch, mode="prefill",
                                    caches=caches, index=None)
    return logits[:, -1], new_caches


def decode_step(cfg: ModelConfig, params: dict, batch: dict, caches
                ) -> Tuple[torch.Tensor, dict]:
    logits, _, new_caches = forward(cfg, params, batch, mode="decode",
                                    caches=caches, index=caches["index"])
    return logits[:, -1], new_caches
