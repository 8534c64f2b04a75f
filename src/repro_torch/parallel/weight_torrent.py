"""Torrent-style weight distribution along the pod axis, on torch.distributed.

The paper's seeder/leecher duality applied to checkpoint restore: instead
of every pod reading the blob store (N x the bytes of egress), the seeder
pod reads once and the pods pass *pieces* peer to peer.  The schedule is
a pipelined ring: the seeder emits piece t at step t, and a pod at ring
distance d >= 1 receives piece t - d + 1 at step t and forwards it at the
next step, so a broadcast of P pieces over n pods takes P + n - 2 steps,
the seeder uploads each piece once (against n - 1 times for a fan-out)
and the last pod of the ring uploads nothing.

Counterpart of `repro.parallel.weight_torrent`, on a
`torch.distributed.device_mesh.DeviceMesh` whose `mesh_dim_names` hold
the pod axis.  Each rank passes its own buffer; every step of the ring is
one `dist.batch_isend_irecv` on the axis's process group, whose group
ranks give the ring order.  The wire tensors live on the group's device:
CPU for gloo, CUDA for NCCL; a buffer on another device raises.

Unlike the reference, which casts every leaf through f32 (exact for f32,
bf16 and f16, lossy for an integer above 2^24), `torrent_broadcast`
carries each leaf's raw bytes, so every dtype round-trips exactly.
`STATS` counts what this process sent and received.
"""
from __future__ import annotations

import collections
import time
from typing import List, Tuple

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import tree_leaves_with_path

# the ring's piece size where a caller gives no piece count: the
# checkpoint store's swarm piece (`CheckpointStore.swarm_piece_bytes`)
RING_PIECE_BYTES = 4 << 20

# what this process moved: bytes sent and received, ring steps, the
# batches it posted, and the seconds spent in `torrent_broadcast_pieces`
STATS: collections.Counter = collections.Counter()


def reset_stats() -> None:
    STATS.clear()


def axis_group(mesh, axis: str):
    """The process group of ``mesh``'s ``axis``, or None when ``mesh`` is
    None or has no such axis."""
    if mesh is None or axis not in (getattr(mesh, "mesh_dim_names", None)
                                    or ()):
        return None
    return mesh.get_group(axis)


def wire_device(group) -> torch.device:
    """The device a tensor must lie on to cross ``group``: CPU for gloo,
    the current CUDA device for NCCL."""
    backend = dist.get_backend(group)
    if backend == "gloo":
        return torch.device("cpu")
    if backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    raise ValueError(f"unsupported process-group backend {backend!r}")


def _agree(group, dev, *values: int) -> None:
    """Raise on every rank unless all ranks of ``group`` passed the same
    ``values`` (one min and one max all-reduce)."""
    hi = torch.tensor(values, dtype=torch.int64, device=dev)
    lo = hi.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
    if not torch.equal(hi, lo):
        raise ValueError(f"the ranks disagree on {values}: between "
                         f"{lo.tolist()} and {hi.tolist()}")


def torrent_broadcast_pieces(local_pieces: torch.Tensor, mesh,
                             axis: str = "pod",
                             seeder: int = 0) -> torch.Tensor:
    """Broadcast the seeder's ``(P, L)`` pieces to every rank of ``axis``.

    Each rank passes its own ``(P, L)`` buffer on the group's device; only
    the seeder's is read (it is returned as is on the seeder).  The other
    ranks get a new tensor holding the seeder's pieces.  ``seeder`` is a
    rank of the axis's group.  A world of 1 returns the input.
    """
    group = axis_group(mesh, axis)
    if group is None:
        raise ValueError(f"the mesh has no axis {axis!r}")
    n = dist.get_world_size(group)
    if n == 1:
        return local_pieces
    if local_pieces.dim() != 2 or not local_pieces.is_contiguous():
        raise ValueError("local_pieces must be a contiguous (P, L) tensor")
    if local_pieces.device.type != wire_device(group).type:
        raise ValueError(f"local_pieces lie on {local_pieces.device}, but "
                         f"the {dist.get_backend(group)} group sends from "
                         f"{wire_device(group).type} tensors")
    if not 0 <= seeder < n:
        raise ValueError(f"seeder {seeder} is not a rank of {n}")
    P, L = local_pieces.shape
    _agree(group, local_pieces.device, P, L, local_pieces.element_size(),
           seeder)
    t0 = time.perf_counter()
    rank = dist.get_rank(group)
    d = (rank - seeder) % n                 # ring distance from the seeder
    nxt = dist.get_global_rank(group, (rank + 1) % n)
    prv = dist.get_global_rank(group, (rank - 1) % n)
    out = local_pieces if d == 0 else torch.empty_like(local_pieces)
    piece_bytes = L * local_pieces.element_size()
    for t in range(P + n - 2):
        ops = []
        # the seeder emits piece t; a rank at distance d forwards the piece
        # it received last step, t - d; the last rank's sends would land on
        # the seeder, which discards them, so it sends nothing
        sent = t if d == 0 else t - d
        if d < n - 1 and 0 <= sent < P:
            ops.append(dist.P2POp(dist.isend, out[sent], nxt, group))
            STATS["sent_bytes"] += piece_bytes
        got = t - (d - 1)
        if d >= 1 and 0 <= got < P:
            ops.append(dist.P2POp(dist.irecv, out[got], prv, group))
            STATS["received_bytes"] += piece_bytes
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            STATS["batches"] += 1
    STATS["ring_steps"] += P + n - 2
    STATS["seconds"] += time.perf_counter() - t0
    return out


# ------------------------------ pytrees ----------------------------------- #
def _leaves(tree) -> List[torch.Tensor]:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _flatten_to_pieces(tree, n_pieces: int, device=None
                       ) -> Tuple[torch.Tensor, int]:
    """The tree's leaves in sorted-key order, each as its raw bytes,
    packed into a ``(n_pieces, L)`` uint8 tensor on ``device`` (zero
    padded); returns it and the padding."""
    leaves = _leaves(tree)
    total = sum(_nbytes(t) for t in leaves)
    pad = (-total) % n_pieces
    flat = torch.empty(total + pad, dtype=torch.uint8, device=device)
    ofs = 0
    for t in leaves:
        nb = _nbytes(t)
        flat[ofs:ofs + nb].copy_(
            t.detach().contiguous().reshape(-1).view(torch.uint8))
        ofs += nb
    flat[total:].zero_()
    return flat.view(n_pieces, -1), pad


def _unflatten(pieces: torch.Tensor, tree, pad: int):
    """Inverse of `_flatten_to_pieces`: nested dicts shaped after
    ``tree``, each leaf a new tensor of its ``tree`` leaf's shape, dtype
    and device."""
    flat = pieces.reshape(-1)
    ofs = 0

    def rebuild(node):
        nonlocal ofs
        if isinstance(node, dict):
            return {k: rebuild(node[k]) for k in sorted(node)}
        nb = _nbytes(node)
        leaf = flat[ofs:ofs + nb].to(node.device, copy=True)
        ofs += nb
        return leaf.view(node.dtype).reshape(node.shape)

    out = rebuild(tree)
    assert ofs + pad == flat.numel()
    return out


def ring_pieces(tree, piece_bytes: int = RING_PIECE_BYTES) -> int:
    """The piece count that cuts ``tree``'s bytes into pieces of at most
    ``piece_bytes``: the same on every rank that holds the same shapes."""
    return max(1, -(-sum(_nbytes(t) for t in _leaves(tree)) // piece_bytes))


def torrent_broadcast(tree, mesh, axis: str = "pod", seeder: int = 0,
                      n_pieces: int = 0):
    """Nested dicts of tensors: flatten to pieces, ring broadcast,
    unflatten.  Every rank passes a tree of the same structure, shapes and
    dtypes; the seeder's values reach all of them, each leaf on the device
    of the rank's own leaf (only the seeder's values are read).
    ``n_pieces`` (0: the world size, as in the reference) cuts the bytes
    into that many pieces.  The seeder gets its own tree back; a world of
    1, or a mesh without ``axis``, returns ``tree``.
    """
    group = axis_group(mesh, axis)
    if group is None or dist.get_world_size(group) == 1:
        return tree
    n_pieces = n_pieces or dist.get_world_size(group)
    dev = wire_device(group)
    if dist.get_rank(group) == seeder:
        pieces, _ = _flatten_to_pieces(tree, n_pieces, dev)
        torrent_broadcast_pieces(pieces, mesh, axis, seeder)
        return tree
    total = sum(_nbytes(t) for t in _leaves(tree))
    pad = (-total) % n_pieces
    buf = torch.empty((n_pieces, (total + pad) // n_pieces),
                      dtype=torch.uint8, device=dev)
    return _unflatten(torrent_broadcast_pieces(buf, mesh, axis, seeder),
                      tree, pad)


# ----------------------------- cost models -------------------------------- #
def broadcast_cost_model(bytes_total: float, n_pods: int,
                         link_Bps: float = 25e9) -> dict:
    """Analytic cost: torrent (scatter+allgather) vs naive seeder fan-out."""
    torrent_s = 2.0 * bytes_total * (n_pods - 1) / n_pods / link_Bps
    naive_s = bytes_total * (n_pods - 1) / link_Bps
    return {"torrent_s": torrent_s, "naive_s": naive_s,
            "speedup": naive_s / max(torrent_s, 1e-12)}


def cold_start_cost_model(bytes_total: float, n_replicas: int,
                          link_Bps: float = 12.5e6,
                          n_pieces: int = 128) -> dict:
    """Analytic replica cold-start: origin-only vs swarm flash crowd.

    Origin-only serialises R full images through the origin's uplink
    (time ~ R * bytes / link, origin egress R * bytes).  A piece-wise
    swarm needs the origin to upload each piece roughly once; the last
    replica finishes after its own download plus the pipeline ramp of
    ~log2(R) piece-times, and origin egress collapses to ~1 image —
    the bounds Scenario XI's simulated runs should approach.
    """
    piece_s = bytes_total / max(n_pieces, 1) / link_Bps
    origin_s = n_replicas * bytes_total / link_Bps
    swarm_s = bytes_total / link_Bps \
        + piece_s * max(1, n_replicas).bit_length()
    return {"origin_s": origin_s, "swarm_s": swarm_s,
            "origin_egress_bytes": n_replicas * bytes_total,
            "swarm_origin_egress_bytes": bytes_total,
            "speedup": origin_s / max(swarm_s, 1e-12)}
