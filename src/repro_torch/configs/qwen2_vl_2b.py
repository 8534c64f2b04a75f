"""Qwen2-VL-2B — VLM backbone with M-RoPE [arXiv:2409.12191].

Backbone only (per assignment): the vision frontend is a stub and
``input_specs()`` provides precomputed patch/text embeddings of shape
(B, S, d_model); position ids are 3D (t, h, w) for M-RoPE.
"""
from repro_torch.configs.base import ModelConfig, dense_groups, register

CONFIG = register(ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    groups=dense_groups(28),
    mrope=True,
    mrope_sections=(16, 24, 24),   # halves of head_dim/2 = 64 -> t/h/w splits
    rope_theta=1_000_000.0,
    input_kind="embeds",
))
