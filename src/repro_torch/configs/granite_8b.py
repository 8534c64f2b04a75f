"""Granite-8B (code) — llama-architecture dense GQA [arXiv:2405.04324]."""
from repro_torch.configs.base import ModelConfig, dense_groups, register

CONFIG = register(ModelConfig(
    name="granite-8b",
    family="dense",
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=49152,
    groups=dense_groups(36),
    rope_theta=10_000_000.0,
))
