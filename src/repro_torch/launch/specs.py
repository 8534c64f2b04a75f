"""Meta-tensor stand-ins for every input of a cell's step (no memory).

Counterpart of `repro.launch.specs`, whose ``ShapeDtypeStruct``s carry a
sharding: here each stand-in is a meta tensor of this rank's local block
under the rules (`DEFAULT_RULES` for train, `infer_rules(cfg)`
otherwise), the shape a rank's SPMD code sees.  Without a mesh the
blocks are the whole arrays.

  train_*    -> train_step(state, batch)
  prefill_*  -> prefill_step(params, batch, caches)   caches of length S
  decode_*   -> decode_step(params, batch, caches)    caches at full length

Two layouts differ from the reference's, because the port's step
computes on the blocks it is given: the AdamW moments are the params'
blocks (the reference's moment specs drop a param's FSDP opt-out, so
the embedding's moments are cut over ``data`` where the embedding is
not, and XLA moves them), and the caches carry ``"global"`` = (batch,
cache_len) and an encoder-decoder's ``"src_len"``, as
`models.model.init_caches` gives them.  The port's steps
take the whole batch on every rank (each cuts its rows): `batch_specs`
without a mesh gives it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import model as M
from repro_torch.parallel.sharding import (DEFAULT_RULES, ShardingRules,
                                           infer_rules, local_shape,
                                           logical_to_mesh_axes,
                                           specs_to_abstract, tree_map_specs)
from repro_torch.training.train_state import train_state_specs


def _meta(mesh, rules, shape, dtype, logical) -> torch.Tensor:
    if mesh is not None:
        shape = local_shape(shape, logical_to_mesh_axes(mesh, shape, logical,
                                                        rules), mesh)
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh=None,
                rules: Optional[ShardingRules] = None) -> dict:
    B, S = shape.global_batch, shape.seq_len
    rules = rules or (DEFAULT_RULES if shape.kind == "train"
                      else infer_rules(cfg))
    tok = lambda s: _meta(mesh, rules, s, torch.int32,  # noqa: E731
                          ("batch",) + (None,) * (len(s) - 1))
    emb = lambda s: _meta(mesh, rules, s, cfg.act_dtype,  # noqa: E731
                          ("batch", None, None))
    pos = lambda s: _meta(mesh, rules, s, torch.int32,  # noqa: E731
                          (None, "batch", None))
    if shape.kind == "decode":
        # one new token against a cache of length S
        d = {"tokens": tok((B, 1))}
        if cfg.mrope:
            d["positions"] = pos((3, B, 1))
        return d
    if cfg.is_encdec:
        St = S // cfg.encdec_tgt_ratio
        d = {"enc_embeds": emb((B, S, cfg.d_model)), "tokens": tok((B, St))}
        if shape.kind == "train":
            d["labels"] = tok((B, St))
        return d
    d = {}
    if shape.kind == "train":
        d["labels"] = tok((B, S))
    if cfg.input_kind == "embeds":
        d["embeds"] = emb((B, S, cfg.d_model))
    else:
        d["tokens"] = tok((B, S))
    if cfg.mrope:
        d["positions"] = pos((3, B, S))
    return d


def cache_abstract(cfg: ModelConfig, shape: ShapeConfig, mesh=None,
                   rules: Optional[ShardingRules] = None,
                   cache_len: Optional[int] = None) -> dict:
    """The caches; ``cache_len`` overrides the self caches' length (a
    prefill whose caches also hold the decode steps that follow)."""
    rules = rules or infer_rules(cfg)
    B, S = shape.global_batch, shape.seq_len
    if cache_len is None:
        # an enc-dec prefill's decoder prefix is S // ratio of the S source
        # frames; a decode's self cache is S, its cross k/v the S frames'
        cache_len = (S // cfg.encdec_tgt_ratio
                     if shape.kind == "prefill" and cfg.is_encdec else S)
    tree = tree_map_specs(
        lambda s: _meta(mesh, rules, s.shape, s.dtype, s.logical),
        M.cache_specs_tree(cfg, B, cache_len, src_len=S))
    if mesh is not None:
        tree["global"] = (B, cache_len)
        if cfg.is_encdec:
            tree["src_len"] = S
    return tree


def params_abstract(cfg: ModelConfig, mesh=None,
                    rules: Optional[ShardingRules] = None, dtype=None):
    rules = rules or infer_rules(cfg)
    return specs_to_abstract(M.model_param_specs(cfg), mesh, rules,
                             dtype_override=dtype or cfg.act_dtype)


def state_abstract(cfg: ModelConfig, mesh=None,
                   rules: ShardingRules = DEFAULT_RULES) -> dict:
    """The train state: f32 master params, AdamW moments on the params'
    blocks, the step."""
    params = specs_to_abstract(M.model_param_specs(cfg), mesh, rules)
    moment = lambda t: torch.empty(t.shape, dtype=torch.float32,  # noqa
                                   device="meta")
    step = train_state_specs(cfg)["step"]
    return {"params": params,
            "opt": {k: _map(moment, params) for k in ("m", "v")},
            "step": torch.empty(step.shape, dtype=step.dtype,
                                device="meta")}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def step_args_abstract(cfg: ModelConfig, shape: ShapeConfig, mesh=None,
                       cache_len: Optional[int] = None) -> Tuple:
    """The cell's step arguments as this rank's blocks: (state, batch)
    for train, (params, batch, caches) otherwise."""
    if shape.kind == "train":
        return (state_abstract(cfg, mesh, DEFAULT_RULES),
                batch_specs(cfg, shape, mesh, DEFAULT_RULES))
    r = infer_rules(cfg)
    return (params_abstract(cfg, mesh, r), batch_specs(cfg, shape, mesh, r),
            cache_abstract(cfg, shape, mesh, r, cache_len))
