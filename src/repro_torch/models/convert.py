"""Carry the reference's parameter and cache trees into the port.

The reference keeps its parameters (and caches) as nested dicts of arrays
keyed by the `ParamSpec` paths (``decoder.g0.L5.ssd.wz``,
``shared_attn.attn.wq``, ``embed.lm_head``, ...); the port keeps the same
nested dicts of tensors.  `params_from_reference` takes such a tree as
numpy arrays (``jax.device_get`` of the reference's tree) and returns the
port's, checking every name and shape against a spec tree when one is
given.  `state_from_reference` and `state_to_numpy` carry a whole train
state (``params``, ``opt.m``, ``opt.v``, ``step`` and ``err``) across, in
both directions, so that both packages can start from one state.

`shard_params` cuts a whole tree (numpy arrays or tensors) into this
rank's blocks under a mesh's rules (`param_sharding`), and
`gather_params` puts the blocks of every rank back together.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.swarm_arrays import resolve_device
from repro_torch.parallel import sharding as shlib
from repro_torch.parallel.sharding import _set_path, tree_leaves_with_path


def _to_tensor(a) -> torch.Tensor:
    """A tensor holding a copy of ``a``: the port updates train states in
    place, and that must not reach the caller's arrays."""
    a = np.array(a, order="C", copy=True)
    if a.dtype.name == "bfloat16":          # ml_dtypes' bfloat16
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


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


def state_from_reference(state: dict, cfg=None, *, device="cuda") -> dict:
    """A train state as nested dicts of numpy arrays (the reference's
    state through ``jax.device_get``) -> the port's, on ``device``.  With
    ``cfg``, ``params``, the moments and ``err`` are checked against the
    model's spec tree."""
    from repro_torch.models.model import model_param_specs
    specs = model_param_specs(cfg) if cfg is not None else None
    out = {"params": params_from_reference(state["params"], specs,
                                           device=device),
           "opt": {k: params_from_reference(state["opt"][k], specs,
                                            device=device)
                   for k in ("m", "v")},
           "step": _to_tensor(state["step"]).to(torch.int32).to(
               resolve_device(device))}
    if "err" in state:
        out["err"] = params_from_reference(state["err"], specs,
                                           device=device)
    return out


def state_to_numpy(state: dict) -> dict:
    """The port's train state (or any nested dicts of tensors) as nested
    dicts of numpy arrays on the host, copies of the tensors."""
    if isinstance(state, dict):
        return {k: state_to_numpy(v) for k, v in state.items()}
    return state.detach().to("cpu", copy=True).numpy()


def shard_params(full_tree: dict, spec_tree: dict, mesh, rules, *,
                 device="cuda", params: bool = True) -> dict:
    """This rank's block of every leaf of a whole tree (numpy arrays or
    tensors), on ``device``, as a tensor of its own: `param_sharding`'s
    layout (TP + FSDP), or with ``params=False`` (caches)
    `logical_to_mesh_axes`'."""
    dev = resolve_device(device)
    specs = dict(tree_leaves_with_path(spec_tree))
    out: dict = {}
    for path, leaf in tree_leaves_with_path(full_tree):
        s = specs[path]
        if tuple(np.shape(leaf)) != tuple(s.shape):
            raise ValueError(f"{path}: shape {tuple(np.shape(leaf))}, spec "
                             f"{tuple(s.shape)}")
        lay = (shlib.param_sharding(mesh, s, rules) if params else
               shlib.logical_to_mesh_axes(mesh, s.shape, s.logical, rules))
        blk = shlib.local_shard(leaf, lay, mesh)
        t = (blk if isinstance(blk, torch.Tensor) else _to_tensor(blk))
        _set_path(out, path, t.to(dev).clone(
            memory_format=torch.contiguous_format))
    return out


def gather_params(local_tree: dict, spec_tree: dict, mesh, rules, *,
                  params: bool = True) -> dict:
    """The inverse of `shard_params`: every rank's blocks gathered back
    into the whole leaves (a collective: every rank calls it)."""
    from repro_torch.parallel.collectives import relayout
    specs = dict(tree_leaves_with_path(spec_tree))
    out: dict = {}
    for path, blk in tree_leaves_with_path(local_tree):
        s = specs[path]
        lay = (shlib.param_sharding(mesh, s, rules) if params else
               shlib.logical_to_mesh_axes(mesh, s.shape, s.logical, rules))
        _set_path(out, path, relayout(blk, lay, (None,) * len(lay), mesh))
    return out
