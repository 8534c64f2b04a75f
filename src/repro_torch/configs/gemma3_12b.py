"""Gemma3-12B — dense GQA, 5:1 local:global attention, 128k context.

[hf:google/gemma-3-*-pt; unverified].  48 layers arranged as 8 groups of
(5 x sliding-window local + 1 x global).  Sliding-window attention makes the
model sub-quadratic-dominated, so the 500k decode shape is lowered for it.
"""
from repro_torch.configs.base import GroupSpec, LayerSpec, ModelConfig, register

_LOCAL = LayerSpec(mixer="attn_local", mlp="dense")
_GLOBAL = LayerSpec(mixer="attn", mlp="dense")

CONFIG = register(ModelConfig(
    name="gemma3-12b",
    family="dense",
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=240,
    d_ff=15360,
    vocab_size=262144,
    groups=(GroupSpec((_LOCAL,) * 5 + (_GLOBAL,), 8),),
    window_size=1024,
    qk_norm=True,
    rope_theta=1_000_000.0,
    subquadratic=True,   # sliding-window dominated; 500k decode allowed
))
