"""InternLM2-20B — dense GQA transformer [arXiv:2403.17297]."""
from repro_torch.configs.base import ModelConfig, dense_groups, register

CONFIG = register(ModelConfig(
    name="internlm2-20b",
    family="dense",
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92544,
    groups=dense_groups(48),
    rope_theta=1_000_000.0,
))
