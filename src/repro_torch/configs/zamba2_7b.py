"""Zamba2-7B — hybrid Mamba2 backbone + weight-tied shared attention block.

[arXiv:2411.15242; unverified].  81 Mamba2 layers; a single *shared* (weight-
tied) global-attention block is applied every 6th layer (13 applications over
the first 78 layers, then a 3-layer SSD tail).  Hybrid => the 500k decode shape
runs (SSD state is constant-size; attention KV is sharded over the mesh).
"""
from repro_torch.configs.base import GroupSpec, LayerSpec, ModelConfig, register

_SSD = LayerSpec(mixer="ssd", mlp="none")
_SSD_ATTN = LayerSpec(mixer="ssd", mlp="none", shared_attn=True)

CONFIG = register(ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,                  # width of the shared block's MLP
    vocab_size=32000,
    groups=(
        GroupSpec((_SSD,) * 5 + (_SSD_ATTN,), 13),   # 78 layers, 13 shared-attn hits
        GroupSpec((_SSD,), 3),                        # tail
    ),
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_ngroups=1,
    shared_attn_heads=32,
    shared_attn_kv_heads=32,
    subquadratic=True,
))
