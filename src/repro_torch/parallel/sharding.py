"""Declarative parameters: `ParamSpec` trees and their initialisation.

Counterpart of the mesh-free part of `repro.parallel.sharding`.  A model's
parameters (and its caches) are nested dicts whose leaves are `ParamSpec`s;
`init_params` turns such a tree into the same nested dicts of tensors.
Leaves are visited in sorted-key order, the order in which the reference
flattens its trees, so a leaf's path names the same parameter in both
packages (`decoder.g0.L5.ssd.wz`).

The logical axis names are kept for the parallel slice; nothing here
shards.  `shard_act` has no counterpart: without a mesh it is the identity.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.swarm_arrays import resolve_device


@dataclass(frozen=True)
class ParamSpec:
    """Declarative parameter: shape + logical axes + init recipe."""
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    dtype: Any = torch.float32
    init: str = "normal"          # normal | zeros | ones | embed
    scale: float = 1.0            # multiplier on fan-in init

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} and logical axes "
                             f"{self.logical} differ in rank")


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map_specs(fn: Callable[[ParamSpec], Any], tree):
    """Apply ``fn`` to every `ParamSpec` leaf of a nested dict."""
    if is_spec(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map_specs(fn, v) for k, v in tree.items()}
    raise TypeError(f"not a spec tree node: {type(tree).__name__}")


def tree_leaves_with_path(tree, prefix: str = "", sep: str = "."
                          ) -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs of a nested dict, in sorted-key order, the keys
    joined by ``sep``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves_with_path(
                tree[k], f"{prefix}{sep}{k}" if prefix else str(k), sep)
    else:
        yield prefix, tree


def _std(s: ParamSpec) -> float:
    """The reference's fan-in rule (`repro.parallel.sharding.init_param`):
    fan-in is ``shape[0]``, or ``shape[-2]`` for rank >= 3 (stacked)."""
    if s.init == "embed":
        return s.scale
    fan_in = s.shape[0] if len(s.shape) >= 2 else max(s.shape[-1], 1)
    if len(s.shape) >= 3:
        fan_in = s.shape[-2]
    return s.scale / math.sqrt(max(fan_in, 1))


# f32 elements drawn at a time (1 GiB): a larger leaf is filled in slices
# along its leading axis
DRAW_ELEMENTS = 1 << 28


def init_param(gen: torch.Generator, s: ParamSpec, dtype=None,
               device="cuda") -> torch.Tensor:
    """One leaf in ``dtype`` (the spec's by default).  The normal draw is
    taken in f32 and cast, slice by slice along the leading axis, at most
    `DRAW_ELEMENTS` elements a slice, so the f32 temporary stays at about
    1 GiB; a smaller leaf is one slice (a stacked expert leaf of
    qwen3-moe-30b-a3b, 9.66e9 elements, would need 38.7 GB in one draw)."""
    dev = resolve_device(device)
    dt = dtype or s.dtype
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=dt, device=dev)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=dt, device=dev)
    std = _std(s)
    out = torch.empty(s.shape, dtype=dt, device=dev)
    rows = max(1, DRAW_ELEMENTS // max(1, math.prod(s.shape[1:])))
    for r0 in range(0, s.shape[0], rows):
        part = out[r0:r0 + rows]
        w = torch.randn(part.shape, generator=gen, dtype=torch.float32,
                        device=dev)
        part.copy_(w.mul_(std))
    return out


def init_params(seed: int, tree, dtype=None, device="cuda"):
    """Nested dicts of tensors for a spec tree, drawn from one
    ``torch.Generator`` on ``device`` seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    out: dict = {}
    for path, s in tree_leaves_with_path(tree):
        _set_path(out, path, init_param(gen, s, dtype, dev))
    return out


def init_params_numpy(seed: int, tree, dtype=np.float32):
    """Nested dicts of numpy arrays for a spec tree, drawn from
    ``numpy.random.default_rng(seed)`` by the same rule.  Both packages can
    be handed these arrays, which is how the tests and the card's check
    against the reference share weights."""
    rng = np.random.default_rng(int(seed))
    out: dict = {}
    for path, s in tree_leaves_with_path(tree):
        if s.init == "zeros":
            a = np.zeros(s.shape, dtype)
        elif s.init == "ones":
            a = np.ones(s.shape, dtype)
        else:
            a = rng.standard_normal(s.shape, dtype=np.float32)
            a *= np.float32(_std(s))
            a = a.astype(dtype, copy=False)
        _set_path(out, path, a)
    return out


def _set_path(tree: dict, path: str, value) -> None:
    *heads, last = path.split(".")
    node = tree
    for h in heads:
        node = node.setdefault(h, {})
    node[last] = value
