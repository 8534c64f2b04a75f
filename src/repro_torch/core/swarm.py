"""Torrent-style piece distribution (rarest-first) for bulk payloads.

The paper's extension hook (§V: "allowing the applications to be mirrored or
to be broken to pieces like regular file sharing in torrent") — here it is the
engine behind checkpoint/weight distribution: one seeder holds all pieces;
every node that has a piece seeds it.  With u parallel uploads per node per
round, full replication of P pieces to N nodes completes in

    ~ P/u + log2(N) rounds         (vs. N*P/u for a pure client-server fan-out)

`plan_broadcast` produces a deterministic per-round transfer schedule that
parallel/weight_torrent.py maps onto ppermute steps; `SwarmSim` additionally
models per-link bandwidth for the benchmark.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np


@dataclass
class Transfer:
    round: int
    src: int
    dst: int
    piece: int


def plan_broadcast(n_nodes: int, n_pieces: int, fanout: int = 1,
                   seeder: int = 0) -> List[Transfer]:
    """Deterministic rarest-first broadcast plan.

    Each round every node may upload `fanout` pieces and download at most
    `fanout` pieces.  Returns the transfer list; completeness is guaranteed.
    """
    have: List[Set[int]] = [set() for _ in range(n_nodes)]
    have[seeder] = set(range(n_pieces))
    plan: List[Transfer] = []
    rnd = 0
    while any(len(h) < n_pieces for h in have):
        rnd += 1
        if rnd > 10 * (n_pieces + n_nodes + 2):
            raise RuntimeError("broadcast plan did not converge")
        up = collections.Counter()
        down = collections.Counter()
        # piece rarity = how many nodes hold it
        count = collections.Counter()
        for h in have:
            for p in h:
                count[p] += 1
        # rarest pieces first; for each, match a holder to a needer
        new_have = [set(h) for h in have]
        for piece in sorted(range(n_pieces), key=lambda p: (count[p], p)):
            holders = [n for n in range(n_nodes)
                       if piece in have[n] and up[n] < fanout]
            needers = [n for n in range(n_nodes)
                       if piece not in have[n] and down[n] < fanout
                       and piece not in new_have[n]]
            for dst in needers:
                if not holders:
                    break
                src = holders.pop(0)
                plan.append(Transfer(rnd, src, dst, piece))
                up[src] += 1
                down[dst] += 1
                new_have[dst].add(piece)
        have = new_have
    return plan


def rarest_first_order(missing: Sequence[int], avail: Dict[int, int],
                       offset: int = 0,
                       n_pieces: Optional[int] = None) -> List[int]:
    """Order `missing` pieces by swarm-wide availability, rarest first.

    The same policy `plan_broadcast` applies offline; the live piece
    engine (core/piece_exchange.py) feeds it HAVE-derived holder counts to
    pick which piece to request next.  `offset` rotates the tie-break so
    equal-rarity pieces are picked starting from different positions per
    caller (deterministic random-first-piece).

    `n_pieces` is the manifest's total piece count and fixes the rotation
    modulus: with the old `len(missing)` modulus the tie-break order
    changed every time a piece completed.  Callers that know the manifest
    should always pass it; the fallback (largest missing id + 1) only
    keeps the order stable for a fixed missing set.
    """
    n = max(n_pieces if n_pieces is not None
            else max(missing, default=0) + 1, 1)
    return sorted(missing, key=lambda p: (avail.get(p, 0), (p + offset) % n,
                                          p))


def rarest_first_order_np(missing: Sequence[int], counts: np.ndarray,
                          offset: int = 0,
                          n_pieces: Optional[int] = None) -> List[int]:
    """Vectorized `rarest_first_order` over a per-piece count array.

    `counts[p]` is piece `p`'s availability (the live engine maintains it
    incrementally; full seeders add the same constant everywhere, so the
    partial-holder counts alone produce the identical order).  One argsort
    replaces the per-piece dict lookups, dropping the sort from the pump
    hot path's profile; the scalar version above stays as the reference
    the differential tests compare against.
    """
    m = np.asarray(missing, dtype=np.int64)
    if m.size == 0:
        return []
    n = max(int(n_pieces) if n_pieces is not None else int(m.max()) + 1, 1)
    c = np.asarray(counts)
    # lexsort keys, last is primary: availability, rotated id, raw id
    order = np.lexsort((m, (m + offset) % n, c[m]))
    return m[order].tolist()


def rounds_of(plan: Sequence[Transfer]) -> int:
    return max((t.round for t in plan), default=0)


def naive_rounds(n_nodes: int, n_pieces: int, fanout: int = 1) -> int:
    """Client-server fan-out: the seeder uploads everything itself."""
    total = (n_nodes - 1) * n_pieces
    return (total + fanout - 1) // fanout


@dataclass
class SwarmStats:
    rounds: int
    transfers: int
    seeder_uploads: int
    makespan_s: float


def simulate(plan: Sequence[Transfer], piece_bytes: float,
             link_Bps: float, n_nodes: int, seeder: int = 0) -> SwarmStats:
    per_round_s = piece_bytes / link_Bps
    rounds = rounds_of(plan)
    seeder_up = sum(1 for t in plan if t.src == seeder)
    return SwarmStats(rounds=rounds, transfers=len(plan),
                      seeder_uploads=seeder_up,
                      makespan_s=rounds * per_round_s)
