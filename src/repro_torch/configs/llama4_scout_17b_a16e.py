"""Llama-4 Scout 17B-A16E — MoE 16 experts top-1 + shared expert, early fusion.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].  Every layer is MoE
(interleave step 1 for Scout) with a shared expert of the same width as the
routed experts.  Early-fusion multimodal frontend is a stub: ``input_specs()``
provides precomputed embeddings.
"""
from repro_torch.configs.base import ModelConfig, dense_groups, register

CONFIG = register(ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,              # routed-expert width (assignment value)
    vocab_size=202048,
    groups=dense_groups(48, mlp="moe"),
    num_experts=16,
    experts_per_token=1,
    moe_d_ff=8192,
    shared_expert=True,
    rope_theta=500_000.0,
    input_kind="embeds",    # early fusion: embeddings arrive fused
))
