"""Mixture-of-experts layer: its parameter specs only, so that every
registered architecture has a spec tree and a parameter count.

Counterpart of `repro.models.moe`.  Routing, dispatch and the int8 a2a
custom vjp come with the MoE slice.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import mlp_specs
from repro_torch.parallel.sharding import ParamSpec


def moe_specs(cfg: ModelConfig) -> dict:
    E, dff, d = cfg.num_experts, cfg.moe_d_ff, cfg.d_model
    specs = {
        "router": ParamSpec((d, E), ("embed", None), scale=1.0),
        "wi_gate": ParamSpec((E, d, dff), ("experts", "embed", None)),
        "wi_up": ParamSpec((E, d, dff), ("experts", "embed", None)),
        "wo": ParamSpec((E, dff, d), ("experts", None, "embed")),
    }
    if cfg.shared_expert:
        specs["shared"] = mlp_specs(cfg, d_ff=cfg.moe_d_ff)
    return specs


def moe_block(params: dict, x, cfg: ModelConfig):
    raise NotImplementedError(
        "MoE layers come with the MoE slice (models/moe.py, ROADMAP "
        "queue 1, item 4)")
