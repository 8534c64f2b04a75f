"""Elastic re-meshing: membership change -> (checkpoint, re-mesh, restart).

The tracker's liveness drop (§III.D) maps to a pod failure; the framework's
response is a deterministic resize plan: pick the largest feasible mesh from
the surviving pods, remap FSDP shards, and resume from the newest checkpoint.

Counterpart of `repro.cluster.elastic`: plain Python, the same code.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass
class ElasticPlan:
    old_pods: int
    new_pods: int
    mesh_shape: Tuple[int, ...]
    mesh_axes: Tuple[str, ...]
    batch_scale: float            # global batch rescale to keep tokens/step
    needs_restart: bool
    reshard: str                  # "torrent" | "none"


def plan_resize(alive_pods: int, chips_per_pod: int = 256,
                model_parallel: int = 16,
                old_pods: Optional[int] = None) -> ElasticPlan:
    """Largest power-of-two pod count <= alive keeps collectives balanced."""
    assert alive_pods >= 1
    pods = 1
    while pods * 2 <= alive_pods:
        pods *= 2
    data = chips_per_pod // model_parallel
    if pods == 1:
        shape, axes = (data, model_parallel), ("data", "model")
    else:
        shape, axes = (pods, data, model_parallel), ("pod", "data", "model")
    old = old_pods if old_pods is not None else alive_pods
    return ElasticPlan(
        old_pods=old,
        new_pods=pods,
        mesh_shape=shape,
        mesh_axes=axes,
        batch_scale=pods / max(old, 1),
        needs_restart=pods != old,
        reshard="torrent" if pods != old else "none",
    )
