"""Random weights for a configuration, drawn on the device from the seed.

The leaves' names, shapes and kinds (zeros, ones, normal, embedding) are
the program's spec tree (`models.model.model_param_specs`); the values
are the benchmark's own.  Every normal leaf lies in one flat buffer in
the dtype it is served in, filled by a few large draws of one
``torch.Generator`` on the device, then scaled leaf by leaf to
1/sqrt(its true fan-in): the attention's wq / wk / wv to d_model and wo
to heads x head_dim (the spec's own rule takes the head count as their
fan-in, which saturates the softmax and makes a deep random stack
amplify any rounding).  The embedding's std is its spec's scale."""
from __future__ import annotations

import math

import torch

DRAW = 1 << 28           # elements a draw


def _std(path: str, spec) -> float:
    shape, name = spec.shape, path.rsplit(".", 1)[-1]
    if spec.init == "embed":
        return spec.scale
    if path.split(".")[-2:-1] == ["attn"] and name in ("wq", "wk", "wv"):
        return 1.0 / math.sqrt(shape[-3])
    if path.split(".")[-2:-1] == ["attn"] and name == "wo":
        return 1.0 / math.sqrt(shape[-3] * shape[-2])
    fan_in = shape[-2] if len(shape) >= 3 else shape[0] \
        if len(shape) == 2 else max(shape[-1], 1)
    return spec.scale / math.sqrt(max(fan_in, 1))


def draw(seed: int, specs: dict, dtype: torch.dtype, device) -> dict:
    """Nested dicts of tensors for the spec tree ``specs``, in ``dtype``
    on ``device``, from ``seed``: the same seed gives the same weights."""
    from repro_torch.parallel.sharding import _set_path, tree_leaves_with_path
    leaves = list(tree_leaves_with_path(specs))
    normal = [(p, s) for p, s in leaves if s.init not in ("zeros", "ones")]
    total = sum(math.prod(s.shape) for _, s in normal)
    flat = torch.empty(total, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    for i in range(0, total, DRAW):
        part = flat[i:i + DRAW]
        torch.randn(part.shape, generator=gen, dtype=dtype, device=device,
                    out=part)
    out: dict = {}
    at = 0
    for path, s in leaves:
        if s.init == "zeros":
            t = torch.zeros(s.shape, dtype=dtype, device=device)
        elif s.init == "ones":
            t = torch.ones(s.shape, dtype=dtype, device=device)
        else:
            n = math.prod(s.shape)
            t = flat[at:at + n].view(s.shape).mul_(_std(path, s))
            at += n
        _set_path(out, path, t)
    return out
