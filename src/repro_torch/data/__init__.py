from repro_torch.data.pipeline import (  # noqa: F401
    LeasedBatchPipeline,
    SyntheticTokens,
    TokenFileStore,
)
