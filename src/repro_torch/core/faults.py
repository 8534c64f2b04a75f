"""Deterministic fault injection for the discrete-event runtime.

The paper's premise is that volunteer nodes are unreliable: they appear,
disappear and sit behind flaky consumer links (BOINC treats client churn
and result loss as the *default* operating condition).  This module is the
fault model the protocol is tested against — a declarative `FaultPlan`
that `SimRuntime` threads through `send`/`_deliver`/`run`:

  * `LinkFault`   — per-message drop probability, duplication probability
                    and reorder jitter, per link or as a default for every
                    link;
  * `Partition`   — timed network partitions: nodes in different islands
                    cannot exchange messages while the partition is up
                    (in-flight messages crossing the cut are lost);
  * `Crash`       — node crash/restart schedules: a crashed node loses its
                    timers, in-flight work and volatile state; on restart
                    it re-registers (a fresh agent incarnation when a
                    restart factory is registered, so only the disk piece
                    cache survives — the piece-cache rescan path);
  * `drop_next`   — drop the next n messages matching (src, dst, kind)
                    deterministically, no RNG draw (targeted tests).

Every random decision comes from one `random.Random(plan.seed)` owned by
the runtime and is only drawn when the effective fault is non-trivial, so
a zero-fault plan is *provably free*: it produces an event-for-event
identical trace to a runtime with no plan at all (differential-tested in
tests/test_chaos.py).  A chaos run is exactly reproducible from
``(seed, plan)`` within a process; across processes set PYTHONHASHSEED for
bit-identical traces (set iteration order over node ids depends on it).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Tuple


@dataclass(frozen=True)
class LinkFault:
    """Per-message fault rates on a (src, dst) link."""
    drop_p: float = 0.0          # P(message lost)
    dup_p: float = 0.0           # P(message delivered twice)
    jitter_s: float = 0.0        # extra delay ~ U(0, jitter_s) — reordering

    def __bool__(self) -> bool:
        return bool(self.drop_p or self.dup_p or self.jitter_s)


NO_FAULT = LinkFault()


@dataclass
class Partition:
    """A timed partition.  `islands` are disjoint node groups; every node
    not listed belongs to one implicit "rest" island.  While the partition
    is up, messages whose endpoints sit in different islands are lost at
    delivery time (so in-flight traffic crossing the cut dies too)."""
    start_s: float
    end_s: float
    islands: Tuple[FrozenSet[str], ...]

    def __post_init__(self):
        self.islands = tuple(frozenset(g) for g in self.islands)

    def _island(self, node: str) -> Optional[int]:
        for i, group in enumerate(self.islands):
            if node in group:
                return i
        return None                        # the implicit rest-island

    def cuts(self, src: str, dst: str, t: float) -> bool:
        if not (self.start_s <= t < self.end_s):
            return False
        return self._island(src) != self._island(dst)


@dataclass
class Crash:
    """Crash `node` at `at_s`; restart it at `restart_s` (None = stays
    dead).  Volatile state dies with the process; whether anything
    survives depends on the restart path — a registered restart factory
    builds a fresh node (only the on-disk piece cache survives), otherwise
    the old object is resumed with its memory intact."""
    node: str
    at_s: float
    restart_s: Optional[float] = None


@dataclass
class FaultPlan:
    """Everything the chaos layer may do to one run, reproducible from
    ``(seed, plan)``.  A default-constructed plan is the zero-fault plan:
    attaching it to a SimRuntime changes nothing, provably (see module
    docstring)."""
    seed: int = 0
    link: LinkFault = field(default_factory=LinkFault)   # every-link default
    links: Dict[Tuple[str, str], LinkFault] = field(default_factory=dict)
    partitions: List[Partition] = field(default_factory=list)
    crashes: List[Crash] = field(default_factory=list)
    # (src, dst, kind) -> drop the next n matching messages; deterministic
    # (no RNG draw), for targeted loss-recovery tests
    drop_next: Dict[Tuple[str, str, str], int] = field(default_factory=dict)
    # nodes whose links never lose/duplicate/jitter (partitions and
    # crashes still apply) — e.g. keep a reference observer clean
    protected: FrozenSet[str] = frozenset()

    def link_fault(self, src: str, dst: str) -> LinkFault:
        if src in self.protected or dst in self.protected:
            return NO_FAULT
        return self.links.get((src, dst), self.link)

    def cut(self, src: str, dst: str, t: float) -> bool:
        for p in self.partitions:
            if p.cuts(src, dst, t):
                return True
        return False
