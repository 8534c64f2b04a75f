"""Job coordinator: the tracker server repurposed as a list-only scheduler.

Holds work items (data shards, eval tasks, sentinel batches) with the
paper's (d, p, w) cost units and lease/TAIL fault tolerance.  Payload bytes
never transit the coordinator — hosts exchange them peer-to-peer (the
data pipeline reads shards directly; weights move via the swarm).

Heterogeneity-aware placement (paper §III.B): long work (high w) goes to
fast members first; placement prefers members whose running average step
time is lowest, exactly how a volunteer uses published (d, w) to judge an
application.

Counterpart of `repro.cluster.coordinator`: plain Python, the same code.
"""
from __future__ import annotations

import collections
import heapq
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.cluster.heartbeat import HeartbeatMonitor
from repro_torch.core.workunit import LeaseTable


@dataclass
class WorkItem:
    item_id: int
    kind: str                      # "data" | "eval" | "sentinel"
    payload: dict
    d_bytes: float = 0.0           # size unit
    w_est_s: float = 0.0           # working-time unit (est.)
    p: int = 0                     # popularity: times leased
    done: bool = False
    result: Optional[dict] = None


class JobCoordinator:
    def __init__(self, lease_timeout_s: float = 120.0,
                 heartbeat_t_s: float = 10.0, heartbeat_f: int = 3,
                 clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self.items: Dict[int, WorkItem] = {}
        self.queue: List[Tuple[float, int]] = []   # (-w_est, id): long first
        self.leases = LeaseTable(lease_timeout_s)
        self.hb = HeartbeatMonitor(heartbeat_t_s, heartbeat_f,
                                   on_dead=self._on_dead, clock=clock)
        self.member_w: Dict[str, float] = collections.defaultdict(float)
        self.member_n: Dict[str, int] = collections.defaultdict(int)
        self.completed: List[int] = []
        self._next_id = 0

    # ---- membership ------------------------------------------------------
    def join(self, member_id: str, **meta) -> None:
        self.hb.register(member_id, **meta)

    def beat(self, member_id: str) -> None:
        self.hb.beat(member_id)

    def _on_dead(self, member_id: str) -> None:
        for pid in self.leases.drop_volunteer(member_id):
            item = self.items.get(pid)
            if item and not item.done:
                heapq.heappush(self.queue, (-item.w_est_s, pid))

    def sweep(self) -> List[str]:
        return self.hb.sweep()

    # ---- work ------------------------------------------------------------
    def submit(self, kind: str, payload: dict, d_bytes: float = 0.0,
               w_est_s: float = 0.0) -> int:
        iid = self._next_id
        self._next_id += 1
        item = WorkItem(iid, kind, payload, d_bytes, w_est_s)
        self.items[iid] = item
        heapq.heappush(self.queue, (-w_est_s, iid))
        return iid

    def request(self, member_id: str) -> Optional[WorkItem]:
        """Lease the next work item to `member_id` (longest-first)."""
        self.hb.beat(member_id)
        while self.queue:
            _, iid = heapq.heappop(self.queue)
            item = self.items[iid]
            if item.done:
                continue
            item.p += 1
            self.leases.grant(iid, member_id, self.clock())
            return item
        return None

    def complete(self, member_id: str, item_id: int, result: Optional[dict]
                 = None, elapsed_s: float = 0.0) -> bool:
        item = self.items.get(item_id)
        if item is None or item.done:
            return False
        self.leases.release(item_id, member_id)
        item.done = True
        item.result = result
        self.completed.append(item_id)
        # update the member's running w (speed estimate)
        self.member_w[member_id] += elapsed_s
        self.member_n[member_id] += 1
        return True

    def expire_leases(self) -> List[int]:
        """TAIL: re-queue items whose leases timed out."""
        out = []
        now = self.clock()
        for lease in self.leases.expired(now):
            self.leases.release(lease.part_id, lease.volunteer_id)
            item = self.items.get(lease.part_id)
            if item and not item.done:
                heapq.heappush(self.queue, (-item.w_est_s, lease.part_id))
                out.append(lease.part_id)
        return out

    # ---- introspection ----------------------------------------------------
    def member_avg_w(self, member_id: str) -> float:
        n = self.member_n.get(member_id, 0)
        return self.member_w[member_id] / n if n else 0.0

    @property
    def outstanding(self) -> int:
        return sum(1 for i in self.items.values() if not i.done)
