"""Pipeline parallelism over a mesh axis (GPipe schedule, send/recv ring).

Stages live on consecutive ranks of the `stage` mesh axis (typically the
``pod`` axis: one stage per pod, point-to-point activation hand-off — the
same ring the weight torrent uses).  Microbatches stream through with the
classic (M + L - 1)-step schedule; at each step a stage computes its
resident microbatch and sends the activation to its successor.  Bubble
fraction = (L-1)/(M+L-1).

Counterpart of `repro.parallel.pipeline`, on a
`torch.distributed.device_mesh.DeviceMesh`.  Each rank runs its own stage;
a step's hand-off is one `dist.batch_isend_irecv` on the axis's group,
whose wire tensors lie on the group's device (CPU for gloo, CUDA for
NCCL): an activation computed elsewhere is copied there to cross, and the
received one back to the microbatches' device.  A stage computes only the
steps at which it holds a microbatch (the reference's shard_map computes
every step and masks).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.parallel.weight_torrent import axis_group, wire_device


def _stage(tree, s: int):
    if isinstance(tree, dict):
        return {k: _stage(v, s) for k, v in tree.items()}
    return tree[s]


def pipeline_apply(stage_fn: Callable, stage_params, x_microbatches,
                   mesh, axis: str = "pod"):
    """Run `stage_fn(params_s, x) -> x` through L pipeline stages.

    stage_params: a tensor or nested dict of tensors with leading stage
    axis L; rank s of `axis` runs stage s on `stage_params[s]`.
    x_microbatches: (M, ...) microbatch stack, the same on every rank.
    Returns the (M, ...) outputs of the final stage on every rank of
    `axis` (broadcast from the last stage), on the microbatches' device.
    """
    group = axis_group(mesh, axis)
    if group is None:
        raise ValueError(f"the mesh has no axis {axis!r}")
    L = dist.get_world_size(group)
    s = dist.get_rank(group)
    M = x_microbatches.shape[0]
    params = _stage(stage_params, s)
    xs = x_microbatches
    wire = wire_device(group)
    mb_shape, dtype = xs.shape[1:], xs.dtype
    nxt = dist.get_global_rank(group, min(s + 1, L - 1))
    prv = dist.get_global_rank(group, max(s - 1, 0))
    outs = torch.zeros((M,) + tuple(mb_shape), dtype=dtype, device=wire)
    recv = None
    for t in range(M + L - 1):
        m = t - s                       # the microbatch resident at step t
        out = None
        if 0 <= m < M:
            live_in = xs[m] if s == 0 else recv.to(xs.device)
            out = stage_fn(params, live_in)
            if out.shape != mb_shape or out.dtype != dtype:
                raise ValueError(
                    f"stage_fn must keep the microbatch's shape and dtype "
                    f"{tuple(mb_shape)} {dtype}, gave {tuple(out.shape)} "
                    f"{out.dtype}")
            if s == L - 1:
                outs[m].copy_(out)
        ops = []
        if out is not None and s < L - 1:
            ops.append(dist.P2POp(dist.isend, out.to(wire).contiguous(),
                                  nxt, group))
        if s > 0 and 0 <= t - (s - 1) < M:      # the predecessor's output
            recv = torch.empty(mb_shape, dtype=dtype, device=wire)
            ops.append(dist.P2POp(dist.irecv, recv, prv, group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    if L > 1:
        dist.broadcast(outs, dist.get_global_rank(group, L - 1), group=group)
    return outs.to(xs.device)


def pipeline_bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
