"""Pod/host liveness with the paper's (t, f) semantics (§III.D).

A member must report within `t` seconds; after `f` consecutive misses it is
declared dead, its leases are returned, and an elastic resize plan is
emitted.  This is the datacenter port of the tracker's PING/VAL loop.

Counterpart of `repro.cluster.heartbeat`: plain Python, the same code.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Dict, List, Optional


class MemberState(str, Enum):
    ALIVE = "alive"
    SUSPECT = "suspect"
    DEAD = "dead"


@dataclass
class _Member:
    member_id: str
    last_seen: float
    missed: int = 0
    state: MemberState = MemberState.ALIVE
    meta: dict = field(default_factory=dict)


class HeartbeatMonitor:
    def __init__(self, t_interval_s: float = 10.0, f_max_missed: int = 3,
                 on_dead: Optional[Callable[[str], None]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.t = t_interval_s
        self.f = f_max_missed
        self.on_dead = on_dead
        self.clock = clock
        self.members: Dict[str, _Member] = {}

    def register(self, member_id: str, **meta) -> None:
        self.members[member_id] = _Member(member_id, self.clock(), meta=meta)

    def beat(self, member_id: str) -> None:
        m = self.members.get(member_id)
        if m is None:
            self.register(member_id)
            return
        m.last_seen = self.clock()
        m.missed = 0
        if m.state is MemberState.SUSPECT:
            m.state = MemberState.ALIVE

    def sweep(self) -> List[str]:
        """Advance (t, f) accounting; returns members newly declared dead."""
        now = self.clock()
        newly_dead = []
        for m in self.members.values():
            if m.state is MemberState.DEAD:
                continue
            missed = int((now - m.last_seen) / self.t)
            m.missed = missed
            if missed > self.f:
                m.state = MemberState.DEAD
                newly_dead.append(m.member_id)
                if self.on_dead:
                    self.on_dead(m.member_id)
            elif missed >= 1:
                m.state = MemberState.SUSPECT
        return newly_dead

    def alive(self) -> List[str]:
        return [m.member_id for m in self.members.values()
                if m.state is not MemberState.DEAD]
