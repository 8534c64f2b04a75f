from repro_torch.checkpoint.store import (  # noqa: F401
    CheckpointStore,
    async_save,
)
