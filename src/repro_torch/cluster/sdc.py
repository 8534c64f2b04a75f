"""Silent-data-corruption detection by m_min-way majority voting.

The paper validates untrusted volunteers' results with majority voting
(§III.D); the datacenter analogue is defective chips producing silent data
corruption.  Every K steps the trainer executes a *sentinel batch* redundantly
on m_min data-parallel replica groups and majority-votes a gradient
fingerprint; a minority replica is flagged for quarantine.

Counterpart of `repro.cluster.sdc`, on nested dicts of tensors or arrays.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.validation import VotingPool
from repro_torch.parallel.sharding import tree_leaves_with_path


def _f64(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", torch.float64).numpy().ravel()
    return np.asarray(leaf, np.float64).ravel()


def gradient_fingerprint(grads, n_moments: int = 4) -> Tuple[float, ...]:
    """Cheap, deterministic fingerprint of a gradient tree (nested dicts
    of tensors or arrays), equal to the reference's for the same tree:
    the f64 sums are taken over the leaves in the same order (dict keys
    sorted, as jax flattens a dict)."""
    acc = np.zeros(n_moments, np.float64)
    for _, leaf in tree_leaves_with_path(grads):
        x = _f64(leaf)
        if x.size == 0:
            continue
        acc[0] += float(np.sum(x))
        acc[1] += float(np.sum(np.abs(x)))
        acc[2] += float(np.sum(x * x))
        acc[3] = max(acc[3], float(np.max(np.abs(x))))
    return tuple(np.round(acc, 6))


@dataclass
class SDCReport:
    step: int
    agree: bool
    winner: Optional[Tuple[float, ...]]
    flagged: List[str] = field(default_factory=list)


class SDCValidator:
    """m_min/m_max sentinel validation across replica groups."""

    def __init__(self, m_min: int = 2, m_max: int = 3, every_steps: int = 100):
        self.pool_cfg = (m_min, m_max)
        self.every = every_steps
        self.pools: Dict[int, VotingPool] = {}
        self.votes_raw: Dict[int, List[Tuple[str, Tuple[float, ...]]]] = {}
        self.reports: List[SDCReport] = []

    def due(self, step: int) -> bool:
        return self.every > 0 and step % self.every == 0

    def offer(self, step: int, replica_id: str, grads) -> Optional[SDCReport]:
        fp = gradient_fingerprint(grads)
        pool = self.pools.setdefault(step, VotingPool(*self.pool_cfg))
        self.votes_raw.setdefault(step, []).append((replica_id, fp))
        verdict = pool.offer(step, replica_id, fp)
        if verdict is None:
            return None
        winner, unanimous = verdict
        flagged = []
        if not unanimous and winner is not None:
            flagged = [rid for rid, v in self.votes_raw[step] if v != winner]
        report = SDCReport(step=step, agree=winner is not None,
                           winner=winner, flagged=flagged)
        self.reports.append(report)
        return report
