"""Majority-voting result validation (paper §III.D, after Sarmenta).

A part's result is accepted once at least `quorum` results agree by
majority; malicious/aberrant results are discarded and never reach the
server's status updates.
"""
from __future__ import annotations

import collections
from typing import Any, List, Optional, Tuple


def _canon(r: Any):
    if isinstance(r, (list, tuple)):
        return tuple(_canon(x) for x in r)
    if isinstance(r, dict):
        return tuple(sorted((k, _canon(v)) for k, v in r.items()))
    return r


def majority_vote(results: List[Any], quorum: int = 1
                  ) -> Tuple[Optional[Any], bool]:
    """Returns (winning_result, accepted)."""
    if len(results) < quorum:
        return None, False
    counts = collections.Counter(_canon(r) for r in results)
    winner, n = counts.most_common(1)[0]
    if n * 2 > len(results) or (len(results) == 1 and quorum == 1):
        for r in results:
            if _canon(r) == winner:
                return r, True
    return None, False


class VotingPool:
    """Standalone m_min/m_max voting pool (used by cluster/sdc.py)."""

    def __init__(self, m_min: int = 2, m_max: int = 3):
        assert m_max >= m_min >= 1
        self.m_min = m_min
        self.m_max = m_max
        self.votes: dict = {}

    def offer(self, key, voter: str, value) -> Optional[Tuple[Any, bool]]:
        """Add a vote; returns (winner, unanimous) once decidable else None."""
        slot = self.votes.setdefault(key, [])
        if any(v == voter for v, _ in slot):
            return None
        slot.append((voter, value))
        if len(slot) < self.m_min:
            return None
        winner, ok = majority_vote([x for _, x in slot], quorum=self.m_min)
        if ok:
            unanimous = len({_canon(x) for _, x in slot}) == 1
            return winner, unanimous
        if len(slot) >= self.m_max:
            return None, False
        return None
