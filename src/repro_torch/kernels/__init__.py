"""The port's hand-written Hopper kernels for the model stack, each beside
its plain PyTorch version: `flash_attention` (FlashAttention forward) and
`ssd` (the Mamba2 SSD chunked scan).  Counterpart of `repro.kernels`."""
