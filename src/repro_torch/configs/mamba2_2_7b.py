"""Mamba2-2.7B — attention-free SSD (state-space duality) [arXiv:2405.21060].

Pure SSM stack: 64 layers, d_model 2560, d_state 128, expand 2, head_dim 64.
Sub-quadratic by construction — the 500k decode shape runs (constant-size
recurrent state).
"""
from repro_torch.configs.base import ModelConfig, dense_groups, register

CONFIG = register(ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    d_model=2560,
    num_heads=0,
    num_kv_heads=1,
    head_dim=0,
    d_ff=0,                       # Mamba2 block has no separate MLP
    vocab_size=50280,
    groups=dense_groups(64, mixer="ssd", mlp="none"),
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_ngroups=1,
    ssm_conv_width=4,
    subquadratic=True,
))
