"""SeamlessM4T-medium — encoder-decoder, multimodal [arXiv:2308.11596].

Transformer backbone only: the speech frontend is a stub and the encoder
consumes precomputed frame embeddings (B, S_src, d_model).  12 encoder layers
(bidirectional) + 12 decoder layers (causal self-attn + cross-attn).  Decode
shapes lower the *decoder* step (self-KV cache of seq_len, cross-attn to
seq_len//4 encoder states).  500k decode is skipped: full attention and no
long-context use-case for a speech model.
"""
from repro_torch.configs.base import ModelConfig, dense_groups, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    groups=dense_groups(12),            # decoder
    is_encdec=True,
    encoder_groups=dense_groups(12),    # encoder
    encdec_tgt_ratio=4,
    input_kind="embeds",                # speech frames arrive pre-embedded
))
