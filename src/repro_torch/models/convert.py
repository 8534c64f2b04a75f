"""Carry the reference's parameter and cache trees into the port.

The reference keeps its parameters (and caches) as nested dicts of arrays
keyed by the `ParamSpec` paths (``decoder.g0.L5.ssd.wz``,
``shared_attn.attn.wq``, ``embed.lm_head``, ...); the port keeps the same
nested dicts of tensors.  `params_from_reference` takes such a tree as
numpy arrays (``jax.device_get`` of the reference's tree) and returns the
port's, checking every name and shape against a spec tree when one is
given.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.swarm_arrays import resolve_device
from repro_torch.parallel.sharding import _set_path, tree_leaves_with_path


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if not a.flags.writeable:               # e.g. a view of a jax array
        a = a.copy()
    if a.dtype.name == "bfloat16":          # ml_dtypes' bfloat16
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def params_from_reference(tree: dict, specs: Optional[dict] = None, *,
                          device="cuda") -> dict:
    """Nested dicts of numpy arrays -> the same nested dicts of tensors on
    ``device``, in the arrays' dtypes.  With ``specs`` (`models.model.model_param_specs(cfg)` or
    `cache_specs_tree(...)`), a missing, extra or mis-shaped leaf raises."""
    dev = resolve_device(device)
    leaves = dict(tree_leaves_with_path(tree))
    if specs is not None:
        want = {p: tuple(s.shape) for p, s in tree_leaves_with_path(specs)}
        missing = sorted(set(want) - set(leaves))
        extra = sorted(set(leaves) - set(want))
        bad = sorted(p for p in set(want) & set(leaves)
                     if tuple(np.shape(leaves[p])) != want[p])
        if missing or extra or bad:
            raise ValueError(
                f"tree does not match its specs: missing {missing[:5]}, "
                f"extra {extra[:5]}, mis-shaped "
                f"{[(p, np.shape(leaves[p]), want[p]) for p in bad[:5]]}")
    out: dict = {}
    for path, a in leaves.items():
        _set_path(out, path, _to_tensor(a).to(dev))
    return out
