"""Zamba2-7B-Instruct at its published widths (hf Zyphra/Zamba2-7B-Instruct,
config.json; the base Zamba2-7B has the same shape).

81 Mamba2 layers (d_inner 7,168, 112 heads of 64, d_state 64, 2 B/C groups,
conv 4 with a bias, chunk 256, the gated RMS norm over each group).  The 13
layers of ``hybrid_layer_ids`` (6, 11, 17, ..., 77) first run one of two
shared transformer blocks, alternating, on concat(x, x0): attention of 32
heads and 32 kv heads of head_dim 224 over the 7,168-wide concatenation
(scale (224/2)^-1/2, rope over all 224 dims), then a GELU-gated MLP of
14,336 with a rank-128 adapter per application; the layer's own linear
adds the block's output to its Mamba2 layer's input:
x + mamba(norm(x + linear(block(x, x0)))).  The embedding is tied to the
head (`Zamba2Config`'s default); every norm has eps 1e-5.

The registered ``zamba2-7b`` keeps the JAX package's layout (one shared
attention over d_model after the mixer)."""
from repro_torch.configs.base import GroupSpec, LayerSpec, ModelConfig, register

_SSD = LayerSpec(mixer="ssd", mlp="none")
_HYBRID = LayerSpec(mixer="ssd", mlp="none", shared_attn=True)

CONFIG = register(ModelConfig(
    name="zamba2-7b-instruct",
    family="hybrid",
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=224,
    d_ff=14336,                  # the shared blocks' MLP
    vocab_size=32000,
    groups=(                     # hybrid at layers 6, 11, 17, 23, ..., 77
        GroupSpec((_SSD,) * 6 + (_HYBRID,), 1),
        GroupSpec((_SSD,) * 4 + (_HYBRID,), 1),
        GroupSpec((_SSD,) * 5 + (_HYBRID,), 11),
        GroupSpec((_SSD,), 3),
    ),
    rope_theta=10_000.0,
    attn_scale=(224 / 2) ** -0.5,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_ngroups=2,
    ssm_conv_width=4,
    ssd_chunk=256,
    ssm_conv_bias=True,
    shared_attn_heads=32,
    shared_attn_kv_heads=32,
    shared_blocks=2,
    shared_adapter_rank=128,
    tie_embeddings=True,
    norm_eps=1e-5,
    subquadratic=True,
))
