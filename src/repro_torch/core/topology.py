"""WAN topology model: ISP/cluster islands over the flat LinkModel.

`LinkModel` (core/runtime.py) gives every node an up/downlink, but the
world it connects is flat — no RTTs, no ISP boundaries.  At the scale the
ROADMAP targets ("millions of users") the economics that dominate are
exactly the ones a flat model cannot see: cross-ISP egress cost and WAN
tail latency (Anderson 2018, PAPERS.md).  `Topology` adds the missing
layer:

  * every node belongs to one **island** (an ISP / cluster / region);
  * an **inter-island latency matrix** adds one-way propagation delay to
    every message whose endpoints sit on different islands;
  * an optional **inter-island bandwidth matrix** models the bottleneck
    trunk between two islands: bulk transfers crossing it serialise
    through a shared per-(src-island, dst-island) pipe, exactly like the
    per-node uplink/downlink pipes — concurrent cross-ISP transfers
    queue behind each other while intra-island traffic flows free;
  * a derived **ALTO-style cost map** (`cost_map()` / `cost_row()`):
    small integers, 0 intra-island, scaled with latency across islands —
    what the tracker serves to agents (`COST_MAP`) and the batched
    kernels fold into piece/holder selection (P4P mode, SNIPPETS.md §2).

Flat identity (the invariant tests/test_topology.py pins): with
`topology=None` — or a single-island topology whose intra latency is
zero — `SimRuntime` produces an event-for-event identical trace to a
runtime with no topology at all.  No RNG is drawn, no extra events are
scheduled, and a zero extra latency is never added, mirroring how a
zero-fault `FaultPlan` is provably free.
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence

# ALTO cost ceiling: costs are small ints so selection kernels can fold
# them into composite sort keys without overflow headroom games
COST_CAP = 15


class Topology:
    """Island assignment + inter-island latency/bandwidth matrices."""

    def __init__(self, islands: Dict[str, int], n_islands: int,
                 latency_s: Sequence[Sequence[float]],
                 bandwidth_Bps: Optional[Sequence[Sequence[
                     Optional[float]]]] = None,
                 cost: Optional[Sequence[Sequence[int]]] = None):
        self.n_islands = max(int(n_islands), 1)
        self.islands = dict(islands)
        self.latency_s = [list(row) for row in latency_s]
        self.bandwidth_Bps = ([list(row) for row in bandwidth_Bps]
                              if bandwidth_Bps is not None else None)
        self._cost = ([list(row) for row in cost]
                      if cost is not None else self._derive_cost())

    # ------------------------------ queries ----------------------------- #
    def island_of(self, node_id: str) -> int:
        """Island index for a node; unmapped nodes live on island 0 (the
        tracker, late joiners a scenario never assigned)."""
        return self.islands.get(node_id, 0)

    def latency(self, si: int, di: int) -> float:
        return self.latency_s[si][di]

    def trunk_Bps(self, si: int, di: int) -> Optional[float]:
        if self.bandwidth_Bps is None:
            return None
        return self.bandwidth_Bps[si][di]

    def _derive_cost(self) -> List[List[int]]:
        """ALTO costs from the latency matrix: 0 intra-island, else a
        small integer growing with one-way latency (10ms per step),
        clamped to COST_CAP.  Cross-island is never cheaper than 1."""
        k = self.n_islands
        cost = [[0] * k for _ in range(k)]
        for i in range(k):
            for j in range(k):
                if i == j:
                    continue
                cost[i][j] = max(1, min(COST_CAP,
                                        1 + int(self.latency_s[i][j] / 0.01)))
        return cost

    def cost_map(self) -> List[List[int]]:
        """The full K x K ALTO cost matrix (row = source island)."""
        return [list(row) for row in self._cost]

    def cost_row(self, island: int) -> List[int]:
        """Endpoint costs from one island to every island — what an agent
        on that island receives in its COST_MAP message."""
        return list(self._cost[island])

    def cost(self, src: str, dst: str) -> int:
        return self._cost[self.island_of(src)][self.island_of(dst)]

    # ----------------------------- factories ---------------------------- #
    @classmethod
    def flat(cls, node_ids: Sequence[str] = ()) -> "Topology":
        """Single island, zero extra latency: provably inert (the flat
        trace-identity differential test runs against this)."""
        return cls({n: 0 for n in node_ids}, 1, [[0.0]])

    @classmethod
    def make(cls, node_ids: Sequence[str], n_islands: int, *,
             seed: int = 0,
             wan_latency_s: tuple = (0.02, 0.08),
             trunk_Bps: Optional[float] = None) -> "Topology":
        """Seeded heterogeneous WAN: nodes assigned round-robin to
        `n_islands` islands, symmetric inter-island latencies drawn from
        U(wan_latency_s) by `random.Random(seed)`, intra-island extra
        latency zero (the LinkModel base latency covers the LAN), and an
        optional uniform trunk bandwidth per island pair."""
        k = max(int(n_islands), 1)
        rng = random.Random(seed)
        lat = [[0.0] * k for _ in range(k)]
        lo, hi = wan_latency_s
        for i in range(k):
            for j in range(i + 1, k):
                d = rng.uniform(lo, hi)
                lat[i][j] = lat[j][i] = d
        bw = None
        if trunk_Bps is not None:
            bw = [[None if i == j else float(trunk_Bps)
                   for j in range(k)] for i in range(k)]
        islands = {n: i % k for i, n in enumerate(node_ids)}
        return cls(islands, k, lat, bandwidth_Bps=bw)
