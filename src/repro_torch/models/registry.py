"""Convenience re-exports for model construction."""
from repro_torch.models.model import (  # noqa: F401
    cache_specs_tree,
    count_params,
    decode_step,
    forward,
    model_param_specs,
    prefill,
)
