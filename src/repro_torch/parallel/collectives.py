"""Collectives over named mesh axes, on torch.distributed.

The counterpart of the collectives inside the reference's `shard_map`
bodies (`jax.lax.psum`, `pmax`, `pmean`, `all_gather`, `psum_scatter`,
`all_to_all`, `axis_index`), for the port's SPMD on local shards.  Each
takes one mesh axis or a tuple of them; a tuple is one group over the
product of those axes, its ranks flattened in the tuple's order (the
first axis major), as the reference flattens ``("data", "model")``.
`relayout` moves a local shard from one layout to another with them.

The wire is the group's device, chosen as `weight_torrent.wire_device`
chooses it: CPU for gloo, CUDA for NCCL.  Gloo carries only CPU tensors
for most collectives, so on a gloo group a CUDA tensor takes an explicit
hop to the host and back, which `STATS` counts (``hop_bytes``,
``hop_calls``); the compute stays on the card.  A tensor on a device the
group cannot carry otherwise (a CPU tensor on NCCL) raises.

Reductions of bf16 / f16 run in f32 on the wire and round once at the
end.  `psum_scatter` is an all-reduce and a local slice (gloo has no
reduce-scatter on every build).  `STATS` also counts each kind's calls
and the bytes this rank put on the wire.
"""
from __future__ import annotations

import collections
import time
from typing import Dict, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import (axis_sizes, entry_axes,
                                           mesh_coords, shard_index)

Axes = Union[str, Sequence[str]]

# what this process moved: calls by kind, wire bytes, the host hop's bytes
# and calls, and the seconds spent inside these functions
STATS: collections.Counter = collections.Counter()

# (id(mesh), axes) -> (mesh, group, order): ``order[i]`` is the group rank
# of the rank at flattened index i
_GROUPS: Dict[tuple, tuple] = {}


def reset_stats() -> None:
    STATS.clear()


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_size(axes: Axes, mesh) -> int:
    sizes = axis_sizes(mesh)
    n = 1
    for a in _axes(axes):
        n *= sizes[a]
    return n


def axis_index(axes: Axes, mesh) -> int:
    """This rank's index along ``axes``, flattened in their order."""
    return shard_index(mesh, _axes(axes))


def _group(mesh, axes: Tuple[str, ...]):
    """(group, order) for this rank over ``axes``.  A tuple of axes makes
    its subgroups on first use, which every rank reaches at the same
    point of the SPMD program."""
    key = (id(mesh), axes)
    if key not in _GROUPS:
        names = list(mesh.mesh_dim_names)
        if len(axes) == 1:
            group = mesh.get_group(axes[0])
        else:
            rest = [i for i, n in enumerate(names) if n not in axes]
            perm = rest + [names.index(a) for a in axes]
            n = axis_size(axes, mesh)
            rows = mesh.mesh.permute(perm).reshape(-1, n).tolist()
            group, _ = dist.new_subgroups_by_enumeration(rows)
        # the global ranks of my group, in flattened order
        coords = mesh_coords(mesh)
        idx = tuple(slice(None) if name in axes else coords[name]
                    for name in names)
        kept = [name for name in names if name in axes]
        flat = mesh.mesh[idx].permute([kept.index(a) for a in axes]
                                      ).reshape(-1).tolist()
        order = [dist.get_group_rank(group, r) for r in flat]
        _GROUPS[key] = (mesh, group, order)
    return _GROUPS[key][1], _GROUPS[key][2]


def _wire(group) -> str:
    backend = dist.get_backend(group)
    if backend == "gloo":
        return "cpu"
    if backend == "nccl":
        return "cuda"
    raise ValueError(f"unsupported process-group backend {backend!r}")


def _to_wire(x: torch.Tensor, wire: str) -> torch.Tensor:
    if x.device.type == wire:
        return x.contiguous()
    if wire == "cpu" and x.device.type == "cuda":
        STATS["hop_calls"] += 1
        STATS["hop_bytes"] += x.numel() * x.element_size()
        return x.to("cpu")
    raise ValueError(f"a {x.device.type} tensor cannot cross a group whose "
                     f"wire is {wire}")


def _from_wire(y: torch.Tensor, device: torch.device) -> torch.Tensor:
    if y.device == device:
        return y
    STATS["hop_bytes"] += y.numel() * y.element_size()
    return y.to(device)


def _as_words(x: torch.Tensor) -> torch.Tensor:
    """A view of ``x`` whose dtype every backend moves (the bits are
    copied, never computed on): bf16 as f16, bool as uint8."""
    if x.dtype == torch.bfloat16:
        return x.view(torch.float16)
    if x.dtype == torch.bool:
        return x.view(torch.uint8)
    return x


def _reduce(x: torch.Tensor, axes: Axes, mesh, op, kind: str
            ) -> torch.Tensor:
    axes = _axes(axes)
    if axis_size(axes, mesh) == 1:
        return x
    t0 = time.perf_counter()
    group, _ = _group(mesh, axes)
    wide = x.dtype in (torch.bfloat16, torch.float16)
    w = _to_wire(x.float() if wide else x, _wire(group))
    if w.data_ptr() == x.data_ptr():
        w = w.clone()
    STATS[kind] += 1
    STATS["wire_bytes"] += w.numel() * w.element_size()
    dist.all_reduce(w, op=op, group=group)
    out = _from_wire(w, x.device).to(x.dtype)
    STATS["seconds"] += time.perf_counter() - t0
    return out


def psum(x: torch.Tensor, axes: Axes, mesh) -> torch.Tensor:
    return _reduce(x, axes, mesh, dist.ReduceOp.SUM, "psum")


def pmax(x: torch.Tensor, axes: Axes, mesh) -> torch.Tensor:
    return _reduce(x, axes, mesh, dist.ReduceOp.MAX, "pmax")


def pmean(x: torch.Tensor, axes: Axes, mesh) -> torch.Tensor:
    return psum(x, axes, mesh) / axis_size(axes, mesh)


def all_gather(x: torch.Tensor, axes: Axes, mesh, axis: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """Every rank's ``x`` along ``axis`` in flattened-index order:
    concatenated (``tiled``) or stacked on a new ``axis``."""
    axes = _axes(axes)
    n = axis_size(axes, mesh)
    if n == 1:
        return x if tiled else x.unsqueeze(axis)
    t0 = time.perf_counter()
    group, order = _group(mesh, axes)
    w = _as_words(_to_wire(x, _wire(group)))
    parts = [torch.empty_like(w) for _ in range(n)]
    STATS["all_gather"] += 1
    STATS["wire_bytes"] += w.numel() * w.element_size()
    dist.all_gather(parts, w, group=group)
    parts = [parts[order[i]].view(x.dtype) if x.dtype != w.dtype
             else parts[order[i]] for i in range(n)]
    out = torch.cat(parts, dim=axis) if tiled else torch.stack(parts, axis)
    out = _from_wire(out, x.device)
    STATS["seconds"] += time.perf_counter() - t0
    return out


def local_chunk(x: torch.Tensor, axes: Axes, mesh, axis: int
                ) -> torch.Tensor:
    """This rank's block of ``x`` along ``axis`` split over ``axes``."""
    axes = _axes(axes)
    n = axis_size(axes, mesh)
    if n == 1:
        return x
    if x.shape[axis] % n:
        raise ValueError(f"dim {axis} of {tuple(x.shape)} does not split "
                         f"over {axes} ({n})")
    c = x.shape[axis] // n
    return x.narrow(axis, axis_index(axes, mesh) * c, c)


def psum_scatter(x: torch.Tensor, axes: Axes, mesh,
                 scatter_dimension: int = 0, tiled: bool = True
                 ) -> torch.Tensor:
    """The sum over ``axes``, this rank keeping its block of
    ``scatter_dimension`` (tiled)."""
    if not tiled:
        raise ValueError("psum_scatter is tiled only")
    return local_chunk(psum(x, axes, mesh), axes, mesh,
                       scatter_dimension).contiguous()


def all_to_all(x: torch.Tensor, axes: Axes, mesh, split_axis: int,
               concat_axis: int, tiled: bool = True) -> torch.Tensor:
    """Split ``x`` along ``split_axis`` into one block per rank of
    ``axes`` (block i to flattened index i) and concatenate the blocks
    received along ``concat_axis`` in flattened order (tiled)."""
    if not tiled:
        raise ValueError("all_to_all is tiled only")
    axes = _axes(axes)
    n = axis_size(axes, mesh)
    if n == 1:
        return x
    if x.shape[split_axis] % n:
        raise ValueError(f"dim {split_axis} of {tuple(x.shape)} does not "
                         f"split over {axes} ({n})")
    t0 = time.perf_counter()
    group, order = _group(mesh, axes)
    inv = [0] * n
    for f, g in enumerate(order):
        inv[g] = f
    xs = _to_wire(x, _wire(group)).movedim(split_axis, 0)
    c = xs.shape[0] // n
    chunks = xs.reshape((n, c) + tuple(xs.shape[1:]))
    inp = _as_words(chunks[torch.tensor(inv)].contiguous())
    out = torch.empty_like(inp)
    STATS["all_to_all"] += 1
    STATS["wire_bytes"] += inp.numel() * inp.element_size()
    dist.all_to_all_single(out, inp, group=group)
    if out.dtype != x.dtype:
        out = out.view(x.dtype)
    pieces = out[torch.tensor(order)].movedim(1, split_axis + 1)
    res = torch.cat(pieces.unbind(0), dim=concat_axis)
    res = _from_wire(res, x.device)
    STATS["seconds"] += time.perf_counter() - t0
    return res


def relayout(x: torch.Tensor, src, dst, mesh) -> torch.Tensor:
    """``x``, this rank's block under spec ``src``, as its block under
    ``dst``.  A mesh axis group that moves from one dim to another (all
    else equal) is one `all_to_all`; otherwise each dim whose entry
    changes is gathered over its old axes and cut for its new ones."""
    src = [entry_axes(e) for e in src]
    dst = [entry_axes(e) for e in dst]
    if src == dst:
        return x
    diff = [i for i in range(len(src)) if src[i] != dst[i]]
    if len(diff) == 2:
        i, j = diff
        if src[j] == () and dst[i] == () and src[i] and src[i] == dst[j]:
            return all_to_all(x, src[i], mesh, split_axis=j, concat_axis=i)
        if src[i] == () and dst[j] == () and src[j] and src[j] == dst[i]:
            return all_to_all(x, src[j], mesh, split_axis=i, concat_axis=j)
    for i in diff:
        if src[i]:
            x = all_gather(x, src[i], mesh, axis=i)
    for i in diff:
        if dst[i]:
            x = local_chunk(x, dst[i], mesh, i)
    return x
