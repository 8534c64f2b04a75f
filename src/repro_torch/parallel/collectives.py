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
end.  On a gloo group `psum_scatter` is an all-reduce and a local slice
(gloo has no reduce-scatter on every build) and `all_gather` gathers a
list; on an NCCL group they are `reduce_scatter_tensor` and
`all_gather_into_tensor`.  `STATS` also counts each kind's calls and the
bytes this rank put on the wire.

Gradients.  `psum`, `pmean`, `all_gather`, `psum_scatter`, `all_to_all`
(and so `relayout`, and `local_chunk`, a slice) carry a gradient: each
backward is its forward's transpose as `shard_map` takes it, with no
notion of replication: `psum` <-> `psum`, `all_gather` <->
`psum_scatter` over the same axes and dim, `all_to_all` <-> `all_to_all`
with its split and concat dims swapped.  Under that transpose the
cotangent of a value that several ranks hold alike (replicated) is
split across them: its true cotangent is their sum.  So a train step
that seeds each rank's backward with its copy of the (replicated) loss
gets, on every rank, a partial gradient of ``world`` times the loss: a
leaf's gradient is the psum of its partials over the axes it is
replicated on, divided by the world size
(`training.train_state.loss_and_grads`).  No Megatron ``copy_to`` /
``reduce_from`` pair is needed: under `DEFAULT_RULES` the residual is
sequence-sharded, a block's entry is an `all_gather` (backward
reduce-scatter) and its exit a `psum_scatter` (backward all-gather),
the pair's own collectives.  `pmax` carries no gradient.

A fake group (``dist.init_process_group("fake", ...)``, torch's
`FakeProcessGroup`) carries meta tensors and moves nothing: a dry run
(`launch.dryrun`) traces one rank's step through the same code, each
collective counted in `STATS` as it would be on the route it models,
`FAKE_ROUTE` (``"gloo"``: the all-reduce and slice, the gathered list;
``"nccl"``: `reduce_scatter_tensor`, `all_gather_into_tensor`).  While
a `recording` is open, every collective issued on any group appends its
op: the reference's HLO name of what crossed the wire (``all-reduce``,
``all-gather``, ``reduce-scatter``, ``all-to-all``), its operand and
output bytes, the group's size and the mesh axes it spans.
"""
from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, List, Sequence, Tuple, Union

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


# the route a fake group models: "gloo" or "nccl"
FAKE_ROUTE = "gloo"

# the op lists of the open `recording`s
_RECORDINGS: List[list] = []


def reset_stats() -> None:
    STATS.clear()


@contextlib.contextmanager
def recording():
    """The collectives issued inside, as a list of ops (`_note`)."""
    ops: list = []
    _RECORDINGS.append(ops)
    try:
        yield ops
    finally:
        _RECORDINGS.remove(ops)


def _note(kind: str, operand: torch.Tensor, out_bytes: int, n: int,
          axes: Tuple[str, ...]) -> None:
    if _RECORDINGS:
        op = {"kind": kind, "operand_bytes": operand.numel()
              * operand.element_size(), "out_bytes": int(out_bytes),
              "group": n, "axes": list(axes)}
        for ops in _RECORDINGS:
            ops.append(op)


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


def _route(group) -> str:
    """The backend whose route a collective takes: the group's own, or
    `FAKE_ROUTE` on a fake group."""
    backend = dist.get_backend(group)
    if backend == "fake":
        if FAKE_ROUTE not in ("gloo", "nccl"):
            raise ValueError(f"FAKE_ROUTE {FAKE_ROUTE!r}: 'gloo' or 'nccl'")
        return FAKE_ROUTE
    if backend in ("gloo", "nccl"):
        return backend
    raise ValueError(f"unsupported process-group backend {backend!r}")


def _wire(group) -> str:
    """The device the group's tensors cross on: CPU for gloo, CUDA for
    NCCL, meta for a fake group."""
    if dist.get_backend(group) == "fake":
        return "meta"
    return "cpu" if _route(group) == "gloo" else "cuda"


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
    group, order = _group(mesh, axes)
    wide = x.dtype in (torch.bfloat16, torch.float16)
    w = _to_wire(x.float() if wide else x, _wire(group))
    if w.data_ptr() == x.data_ptr():
        w = w.clone()
    STATS[kind] += 1
    STATS["wire_bytes"] += w.numel() * w.element_size()
    _note("all-reduce", w, w.numel() * w.element_size(), len(order), axes)
    dist.all_reduce(w, op=op, group=group)
    out = _from_wire(w, x.device).to(x.dtype)
    STATS["seconds"] += time.perf_counter() - t0
    return out


def _inverse(order):
    """Flattened index of each group rank."""
    inv = [0] * len(order)
    for f, g in enumerate(order):
        inv[g] = f
    return inv


def _all_gather(x: torch.Tensor, axes: Tuple[str, ...], mesh, axis: int
                ) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``axis`` in flattened-index
    order (no autograd)."""
    n = axis_size(axes, mesh)
    if n == 1:
        return x
    t0 = time.perf_counter()
    group, order = _group(mesh, axes)
    wire = _wire(group)
    w = _as_words(_to_wire(x, wire))
    STATS["all_gather"] += 1
    STATS["wire_bytes"] += w.numel() * w.element_size()
    _note("all-gather", w, n * w.numel() * w.element_size(), n, axes)
    if _route(group) == "nccl":
        # one tensor of the group ranks' blocks, in group-rank order
        flat = torch.empty((n,) + tuple(w.shape), dtype=w.dtype,
                           device=w.device)
        dist.all_gather_into_tensor(flat, w, group=group)
        parts = list(flat.unbind(0))
    else:
        parts = [torch.empty_like(w) for _ in range(n)]
        dist.all_gather(parts, w, group=group)
    parts = [parts[order[i]].view(x.dtype) if x.dtype != w.dtype
             else parts[order[i]] for i in range(n)]
    out = _from_wire(torch.cat(parts, dim=axis), x.device)
    STATS["seconds"] += time.perf_counter() - t0
    return out


def _psum_scatter(x: torch.Tensor, axes: Tuple[str, ...], mesh, dim: int
                  ) -> torch.Tensor:
    """The sum over ``axes``, this rank keeping its block of ``dim``
    (no autograd)."""
    n = axis_size(axes, mesh)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {axes} ({n})")
    group, order = _group(mesh, axes)
    if _route(group) != "nccl":
        return local_chunk(_reduce(x, axes, mesh, dist.ReduceOp.SUM,
                                   "psum"), axes, mesh, dim).contiguous()
    t0 = time.perf_counter()
    wide = x.dtype in (torch.bfloat16, torch.float16)
    xs = (x.float() if wide else x).movedim(dim, 0)
    c = xs.shape[0] // n
    # group rank g receives chunk g: put the block of the flattened
    # index that rank holds there
    chunks = xs.reshape((n, c) + tuple(xs.shape[1:]))
    inp = _to_wire(chunks[torch.tensor(_inverse(order),
                                       device=chunks.device)]
                   .reshape(xs.shape).contiguous(), _wire(group))
    out = torch.empty((c,) + tuple(xs.shape[1:]), dtype=inp.dtype,
                      device=inp.device)
    STATS["psum_scatter"] += 1
    STATS["wire_bytes"] += inp.numel() * inp.element_size()
    _note("reduce-scatter", inp, out.numel() * out.element_size(), n, axes)
    dist.reduce_scatter_tensor(out, inp, op=dist.ReduceOp.SUM, group=group)
    out = out.movedim(0, dim).to(x.dtype).contiguous()
    STATS["seconds"] += time.perf_counter() - t0
    return out


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return _reduce(x, axes, mesh, dist.ReduceOp.SUM, "psum")

    @staticmethod
    def backward(ctx, g):
        return (_reduce(g, ctx.axes, ctx.mesh, dist.ReduceOp.SUM, "psum"),
                None, None)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh, axis):
        ctx.axes, ctx.mesh, ctx.axis = axes, mesh, axis
        return _all_gather(x, axes, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return (_psum_scatter(g, ctx.axes, ctx.mesh, ctx.axis), None, None,
                None)


class _PSumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh, dim):
        ctx.axes, ctx.mesh, ctx.dim = axes, mesh, dim
        return _psum_scatter(x, axes, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return (_all_gather(g, ctx.axes, ctx.mesh, ctx.dim), None, None,
                None)


def _grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def psum(x: torch.Tensor, axes: Axes, mesh) -> torch.Tensor:
    """The sum over ``axes``; its backward is a psum of the cotangent."""
    axes = _axes(axes)
    if axis_size(axes, mesh) == 1:
        return x
    if _grad(x):
        return _PSum.apply(x, axes, mesh)
    return _reduce(x, axes, mesh, dist.ReduceOp.SUM, "psum")


def pmax(x: torch.Tensor, axes: Axes, mesh) -> torch.Tensor:
    """The max over ``axes``, with no gradient (the log-sum-exp's shift,
    decode's running max and the int8 scale use it)."""
    return _reduce(x.detach(), axes, mesh, dist.ReduceOp.MAX, "pmax")


def pmean(x: torch.Tensor, axes: Axes, mesh) -> torch.Tensor:
    return psum(x, axes, mesh) / axis_size(axes, mesh)


def all_gather(x: torch.Tensor, axes: Axes, mesh, axis: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """Every rank's ``x`` along ``axis`` in flattened-index order:
    concatenated (``tiled``) or stacked on a new ``axis``.  Its backward
    is `psum_scatter` over the same axes and dim."""
    axes = _axes(axes)
    if not tiled:
        axis = axis % (x.dim() + 1)
        return all_gather(x.unsqueeze(axis), axes, mesh, axis)
    axis = axis % x.dim()
    if axis_size(axes, mesh) == 1:
        return x
    if _grad(x):
        return _AllGather.apply(x, axes, mesh, axis)
    return _all_gather(x, axes, mesh, axis)


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
    ``scatter_dimension`` (tiled).  Its backward is `all_gather` over the
    same axes and dim."""
    if not tiled:
        raise ValueError("psum_scatter is tiled only")
    axes = _axes(axes)
    dim = scatter_dimension % x.dim()
    if axis_size(axes, mesh) == 1:
        return x
    if _grad(x):
        return _PSumScatter.apply(x, axes, mesh, dim)
    return _psum_scatter(x, axes, mesh, dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh, split_axis, concat_axis):
        ctx.args = (axes, mesh, concat_axis, split_axis)
        return _all_to_all(x, axes, mesh, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return (_all_to_all(g, *ctx.args), None, None, None, None)


def all_to_all(x: torch.Tensor, axes: Axes, mesh, split_axis: int,
               concat_axis: int, tiled: bool = True) -> torch.Tensor:
    """Split ``x`` along ``split_axis`` into one block per rank of
    ``axes`` (block i to flattened index i) and concatenate the blocks
    received along ``concat_axis`` in flattened order (tiled).  Its
    backward is the all-to-all with the two dims swapped."""
    if not tiled:
        raise ValueError("all_to_all is tiled only")
    axes = _axes(axes)
    split_axis, concat_axis = split_axis % x.dim(), concat_axis % x.dim()
    if axis_size(axes, mesh) == 1:
        return x
    if _grad(x):
        return _AllToAll.apply(x, axes, mesh, split_axis, concat_axis)
    return _all_to_all(x, axes, mesh, split_axis, concat_axis)


def _all_to_all(x: torch.Tensor, axes: Tuple[str, ...], mesh,
                split_axis: int, concat_axis: int) -> torch.Tensor:
    n = axis_size(axes, mesh)
    if x.shape[split_axis] % n:
        raise ValueError(f"dim {split_axis} of {tuple(x.shape)} does not "
                         f"split over {axes} ({n})")
    t0 = time.perf_counter()
    group, order = _group(mesh, axes)
    inv = _inverse(order)
    xs = _to_wire(x, _wire(group)).movedim(split_axis, 0)
    c = xs.shape[0] // n
    chunks = xs.reshape((n, c) + tuple(xs.shape[1:]))
    inp = _as_words(chunks[torch.tensor(inv)].contiguous())
    out = torch.empty_like(inp)
    STATS["all_to_all"] += 1
    STATS["wire_bytes"] += inp.numel() * inp.element_size()
    _note("all-to-all", inp, inp.numel() * inp.element_size(), n, axes)
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
