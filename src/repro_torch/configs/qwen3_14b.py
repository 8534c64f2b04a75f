"""Qwen3-14B — dense GQA with qk-norm [hf:Qwen/Qwen3-8B family]."""
from repro_torch.configs.base import ModelConfig, dense_groups, register

CONFIG = register(ModelConfig(
    name="qwen3-14b",
    family="dense",
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    groups=dense_groups(40),
    qk_norm=True,
    rope_theta=1_000_000.0,
))
