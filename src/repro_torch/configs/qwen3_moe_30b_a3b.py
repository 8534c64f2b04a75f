"""Qwen3-MoE-30B-A3B — 128 experts, top-8, qk-norm [hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.configs.base import ModelConfig, dense_groups, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,            # decoupled from d_model/num_heads, as in HF config
    d_ff=768,                # per-expert width (assignment value)
    vocab_size=151936,
    groups=dense_groups(48, mlp="moe"),
    num_experts=128,
    experts_per_token=8,
    moe_d_ff=768,
    qk_norm=True,
    rope_theta=1_000_000.0,
))
