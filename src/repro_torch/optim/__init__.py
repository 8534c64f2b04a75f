from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    adamw_init_specs,
    adamw_update,
    lr_schedule,
)
