"""Execution runtimes for the tracker/agent protocol.

Two interchangeable runtimes drive the same Node code:

  * SimRuntime    — deterministic discrete-event simulation on a virtual
                    clock.  Work durations come from each application's
                    cost_fn and per-node speed factors; message latency from a
                    simple base+bytes/bw model.  Used to reproduce the paper's
                    Tables I-IV at full scale in milliseconds of wall time.
  * ThreadRuntime — a real-time event loop (dispatcher thread + worker pool).
                    RUN executes the actual application function (the prime
                    search really runs).  Used by examples and integration
                    tests at reduced scale.

Nodes are event-driven: the runtime calls ``on_message`` and ``on_timer``.
"""
from __future__ import annotations

import heapq
import itertools
import queue
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from repro_torch.core.faults import FaultPlan
from repro_torch.core.messages import Msg
from repro_torch.core.topology import Topology


class Node:
    node_id: str = "?"

    def start(self, rt: "Runtime") -> None:
        self.rt = rt

    def on_message(self, msg: Msg) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def on_timer(self, name: str) -> None:
        pass

    def on_work_done(self, tag: Any, result: Any, elapsed_s: float) -> None:
        pass


@dataclass
class LinkModel:
    base_latency_s: float = 0.002
    bandwidth_Bps: float = 100e6 / 8 * 0.9   # ~100BASE-TX payload rate
    # per-node uplink capacity; when set, a node's *bulk* sends serialise
    # through its egress pipe (so a seeder fanning out to N leechers pays N
    # transfer times, which is what makes swarm vs single-seeder
    # measurable).  Control messages below the threshold interleave with
    # bulk transfers, as packets do on a real link — otherwise a seeder's
    # PONGs would queue behind multi-MB pieces and the tracker would
    # declare it dead.
    uplink_Bps: Optional[float] = None
    # per-node downlink capacity, mirroring the uplink model: bulk
    # transfers *into* a node serialise through its ingress pipe.  Without
    # it an unchoked seeder could fan N pieces into one leecher "for free"
    # and choking would not be measurable.
    downlink_Bps: Optional[float] = None
    bulk_threshold_bytes: int = 1 << 16

    def latency(self, size_bytes: int) -> float:
        return self.base_latency_s + size_bytes / self.bandwidth_Bps

    def tx_time(self, size_bytes: int) -> float:
        return size_bytes / (self.uplink_Bps or self.bandwidth_Bps)

    def rx_time(self, size_bytes: int) -> float:
        return size_bytes / (self.downlink_Bps or self.bandwidth_Bps)


class Runtime:
    def now(self) -> float:
        raise NotImplementedError

    def send(self, dst: str, msg: Msg) -> None:
        raise NotImplementedError

    def set_timer(self, node_id: str, name: str, delay_s: float,
                  periodic: bool = False) -> None:
        raise NotImplementedError

    def cancel_timer(self, node_id: str, name: str) -> None:
        raise NotImplementedError

    def submit_work(self, node_id: str, tag: Any, fn: Callable[[], Any],
                    sim_duration_s: Optional[float] = None) -> None:
        raise NotImplementedError

    def cancel_work(self, node_id: str, tag: Any) -> bool:
        """Best-effort abort of submitted-but-unfinished work.  Returns True
        when the job was removed before completing (its ``on_work_done``
        will never fire); False when it already ran or cannot be stopped —
        the caller must then discard the eventual result itself."""
        return False


# sentinel result delivered by ThreadRuntime for work cancelled after its
# queue pop could no longer be prevented; nodes must discard it
CANCELLED = object()


# --------------------------------------------------------------------------- #
class SimRuntime(Runtime):
    """Deterministic discrete-event simulator.

    An optional `FaultPlan` (core.faults) injects seeded, reproducible
    chaos: per-link loss/duplication/jitter, timed partitions and node
    crash/restart schedules.  All fault randomness comes from one
    `random.Random(plan.seed)` and is only drawn when the effective fault
    is non-trivial, so a zero-fault plan leaves the event trace untouched.

    An optional `Topology` (core.topology) layers a WAN over the flat
    LinkModel: messages crossing island (ISP) boundaries pay the
    inter-island latency, bulk transfers additionally serialise through
    the shared inter-island trunk pipe (when the topology carries a
    bandwidth matrix), and every cross-island byte is accounted in
    `cross_isp_bytes` — the metric Scenario IX's P4P selection exists to
    cut.  `topology=None` (or a flat single-island topology) leaves the
    trace event-for-event identical, like a zero-fault plan.
    """

    def __init__(self, link: Optional[LinkModel] = None,
                 faults: Optional[FaultPlan] = None,
                 topology: Optional[Topology] = None):
        self.nodes: Dict[str, Node] = {}
        self.link = link or LinkModel()
        self._t = 0.0
        self._seq = itertools.count()
        # event heap entries are (time, seq, bound_method, args) tuples —
        # no per-event closure allocation on the send/timer hot paths
        self._heap: List[Tuple[float, int, Callable, tuple]] = []
        # timer cancellation by version counter: the scheduled event
        # carries the version it was armed with and fires only while it is
        # still current.  Unlike the old tombstone set (which grew with
        # every cancel until the same timer was re-armed), this stays at
        # one dict entry per live (node, name) key.
        self._timer_ver: Dict[Tuple[str, str], int] = {}
        self.speed: Dict[str, float] = {}
        # total events executed by run() — simulator-throughput metric
        self.events_processed = 0
        # run_batched wall split: message-burst drains vs on_tick passes
        self.batched_drain_s = 0.0
        self.batched_tick_s = 0.0
        # per-node egress accounting and uplink/downlink-contention state
        self.tx_bytes: Dict[str, int] = {}
        self._uplink_free: Dict[str, float] = {}
        self._downlink_free: Dict[str, float] = {}
        # processor-sharing executor state (per node): jobs share the core,
        # like the paper's clients running two app processes on one-core VMs
        self._ps_jobs: Dict[str, Dict[int, list]] = {}
        self._ps_last: Dict[str, float] = {}
        self._ps_event: Dict[str, int] = {}
        # called with the node id on every crash() — the authoritative
        # liveness signal for batched-mode swarm state (PEER_GONE relays
        # can arrive after a restart and must not wipe the fresh state)
        self.crash_hooks: List[Callable[[str], None]] = []
        # --- WAN topology (core.topology) ------------------------------ #
        self.topology = topology
        # cross-island egress accounting — Scenario IX's headline metric
        self.cross_isp_bytes = 0
        # (src_island, dst_island) -> time the shared trunk frees up
        self._xlink_free: Dict[Tuple[int, int], float] = {}
        # --- fault injection (core.faults) ----------------------------- #
        self.faults = faults
        self._rng = random.Random(faults.seed) if faults is not None else None
        # private copy: drop_next counters are consumed as messages match
        self._drop_next: Dict[Tuple[str, str, str], int] = \
            dict(faults.drop_next) if faults is not None else {}
        self.crashed: Set[str] = set()
        # node_id -> factory building a fresh incarnation on restart; when
        # absent the old object is resumed with its memory intact
        self.restart_factory: Dict[str, Callable[[], Node]] = {}
        self._crashed_nodes: Dict[str, Tuple[Node, float]] = {}
        self.dropped_msgs = 0
        self.dup_msgs = 0
        self.crash_count = 0
        self.restart_count = 0
        if faults is not None:
            for c in faults.crashes:
                self._at(c.at_s, self.crash, (c.node,))
                if c.restart_s is not None:
                    self._at(c.restart_s, self.restart, (c.node,))

    def add_node(self, node: Node, speed: float = 1.0) -> None:
        self.nodes[node.node_id] = node
        self.speed[node.node_id] = speed
        node.start(self)

    def now(self) -> float:
        return self._t

    def _at(self, t: float, fn: Callable, args: tuple = ()) -> None:
        heapq.heappush(self._heap, (t, next(self._seq), fn, args))

    def send(self, dst: str, msg: Msg) -> None:
        src = msg.src
        self.tx_bytes[src] = self.tx_bytes.get(src, 0) + msg.size_bytes
        bulk = msg.size_bytes >= self.link.bulk_threshold_bytes
        if bulk and (self.link.uplink_Bps is not None
                     or self.link.downlink_Bps is not None):
            # the endpoint pipes replace the generic shared-bandwidth term
            # (they ARE the transfer-time model for bulk messages): first
            # serialise through the sender's uplink, then through the
            # receiver's downlink, so concurrent seeders fanning into one
            # node queue behind each other at its ingress
            t = self._t
            if self.link.uplink_Bps is not None:
                start = max(t, self._uplink_free.get(src, 0.0))
                t = start + self.link.tx_time(msg.size_bytes)
                self._uplink_free[src] = t
            if self.link.downlink_Bps is not None:
                start = max(t, self._downlink_free.get(dst, 0.0))
                t = start + self.link.rx_time(msg.size_bytes)
                self._downlink_free[dst] = t
            at = t + self.link.base_latency_s
        else:
            at = self._t + self.link.latency(msg.size_bytes)
        if self.topology is not None:
            at = self._topo_delay(src, dst, msg, bulk, at)
        if self.faults is not None:
            # loss/dup/jitter apply past the pipe model: the bytes were
            # transmitted (and accounted), the network lost them.  RNG is
            # drawn only for non-trivial faults so a zero-fault plan
            # leaves the trace untouched.
            key = (src, dst, msg.kind)
            n = self._drop_next.get(key, 0)
            if n > 0:
                self._drop_next[key] = n - 1
                self.dropped_msgs += 1
                return
            fault = self.faults.link_fault(src, dst)
            if fault:
                if fault.drop_p and self._rng.random() < fault.drop_p:
                    self.dropped_msgs += 1
                    return
                if fault.jitter_s:
                    at += self._rng.random() * fault.jitter_s
                if fault.dup_p and self._rng.random() < fault.dup_p:
                    # duplicate delivery, independently jittered (payloads
                    # are treated read-only by receivers, so sharing the
                    # Msg is safe — same convention as tracker relays)
                    self.dup_msgs += 1
                    extra = (self._rng.random() * fault.jitter_s
                             if fault.jitter_s else self.link.base_latency_s)
                    self._at(at + extra, self._deliver, (dst, msg))
        self._at(at, self._deliver, (dst, msg))

    def _topo_delay(self, src: str, dst: str, msg: Msg,
                    bulk: bool, at: float) -> float:
        """WAN leg of a transfer.  Intra-island messages pass through
        untouched (a zero latency is never added, so a flat topology is
        event-for-event identical to no topology).  Cross-island bulk
        transfers additionally serialise through the shared per-island-pair
        trunk pipe when the topology carries a bandwidth matrix."""
        topo = self.topology
        si = topo.island_of(src)
        di = topo.island_of(dst)
        if si != di:
            self.cross_isp_bytes += msg.size_bytes
            if bulk:
                bw = topo.trunk_Bps(si, di)
                if bw is not None:
                    start = max(at, self._xlink_free.get((si, di), 0.0))
                    at = start + msg.size_bytes / bw
                    self._xlink_free[(si, di)] = at
        extra = topo.latency(si, di)
        if extra:
            at += extra
        return at

    def _deliver(self, dst: str, msg: Msg) -> None:
        if self.faults is not None \
                and self.faults.cut(msg.src, dst, self._t):
            # partitions cut at delivery time, so in-flight messages
            # crossing the cut are lost too
            self.dropped_msgs += 1
            return
        node = self.nodes.get(dst)
        if node is not None:
            node.on_message(msg)

    # ---- crash / restart (fault injection) ---------------------------- #
    def crash(self, node_id: str) -> None:
        """Kill a node: it stops receiving messages, all its timers and
        in-flight work die.  In-flight messages it already sent still
        deliver (they are in the network, not the process)."""
        node = self.nodes.pop(node_id, None)
        if node is None:
            return
        self.crashed.add(node_id)
        self._crashed_nodes[node_id] = (node, self.speed.get(node_id, 1.0))
        self.crash_count += 1
        for hook in self.crash_hooks:
            hook(node_id)
        for key in [k for k in self._timer_ver if k[0] == node_id]:
            self._timer_ver[key] += 1        # every armed timer dies
        self._ps_jobs.pop(node_id, None)
        self._ps_last.pop(node_id, None)
        self._ps_event.pop(node_id, None)    # scheduled _ps_fire is stale

    def restart(self, node_id: str) -> None:
        """Bring a crashed node back.  A registered `restart_factory`
        builds a fresh incarnation (volatile state lost, only disk
        survives — the realistic crash model); without one the old object
        resumes with its memory intact (suspend/resume).  Either way the
        node's start() runs again, so agents re-register with the
        tracker."""
        if node_id not in self.crashed:
            return
        self.crashed.discard(node_id)
        old, speed = self._crashed_nodes.pop(node_id)
        factory = self.restart_factory.get(node_id)
        node = factory() if factory is not None else old
        self.restart_count += 1
        self.add_node(node, speed=speed)

    def set_timer(self, node_id: str, name: str, delay_s: float,
                  periodic: bool = False) -> None:
        key = (node_id, name)
        ver = self._timer_ver.get(key, 0) + 1    # latest set supersedes
        self._timer_ver[key] = ver
        self._at(self._t + delay_s, self._fire_timer,
                 (key, ver, delay_s, periodic))

    def cancel_timer(self, node_id: str, name: str) -> None:
        key = (node_id, name)
        self._timer_ver[key] = self._timer_ver.get(key, 0) + 1

    def _fire_timer(self, key: Tuple[str, str], ver: int, delay_s: float,
                    periodic: bool) -> None:
        if self._timer_ver.get(key) != ver:
            return                   # cancelled, or superseded by a re-set
        node = self.nodes.get(key[0])
        if node is None:
            return
        node.on_timer(key[1])
        if periodic and self._timer_ver.get(key) == ver:
            self._at(self._t + delay_s, self._fire_timer,
                     (key, ver, delay_s, periodic))

    # ---- processor-sharing work executor ------------------------------ #
    def _ps_advance(self, node_id: str) -> None:
        jobs = self._ps_jobs.setdefault(node_id, {})
        last = self._ps_last.get(node_id, self._t)
        if jobs and self._t > last:
            rate = self.speed.get(node_id, 1.0) / len(jobs)
            dt = self._t - last
            for j in jobs.values():
                j[0] -= dt * rate          # remaining work units
        self._ps_last[node_id] = self._t

    def _ps_schedule(self, node_id: str) -> None:
        jobs = self._ps_jobs.get(node_id, {})
        token = next(self._seq)
        self._ps_event[node_id] = token
        if not jobs:
            return
        rate = self.speed.get(node_id, 1.0) / len(jobs)
        jid, job = min(jobs.items(), key=lambda kv: kv[1][0])
        eta = self._t + max(job[0], 0.0) / rate
        self._at(eta, self._ps_fire, (node_id, token))

    def _ps_fire(self, node_id: str, token: int) -> None:
        if self._ps_event.get(node_id) != token:
            return                          # superseded by a newer event
        self._ps_advance(node_id)
        jobs = self._ps_jobs.get(node_id, {})
        done = [k for k, j in jobs.items() if j[0] <= 1e-9]
        for k in done:
            work, tag, fn, t0 = jobs.pop(k)
            node = self.nodes.get(node_id)
            if node is not None:
                result = fn() if fn is not None else None
                node.on_work_done(tag, result, self._t - t0)
        self._ps_schedule(node_id)

    def submit_work(self, node_id: str, tag: Any, fn: Callable[[], Any],
                    sim_duration_s: Optional[float] = None) -> None:
        """Processor sharing: concurrent jobs on a node split its core, like
        the paper's clients running one process per leeched application."""
        dur = sim_duration_s if sim_duration_s is not None else 0.0
        self._ps_advance(node_id)
        jid = next(self._seq)
        # [remaining_work_units, tag, fn, started_at]
        self._ps_jobs.setdefault(node_id, {})[jid] = [dur, tag, fn, self._t]
        self._ps_schedule(node_id)

    def cancel_work(self, node_id: str, tag: Any) -> bool:
        """Remove an unfinished job from the processor-sharing executor; the
        remaining jobs immediately reclaim its share of the core."""
        jobs = self._ps_jobs.get(node_id)
        if not jobs:
            return False
        for jid, job in list(jobs.items()):
            if job[1] == tag:
                self._ps_advance(node_id)
                jobs.pop(jid, None)
                self._ps_schedule(node_id)
                return True
        return False

    def run(self, until: Optional[float] = None,
            stop_when: Optional[Callable[[], bool]] = None,
            max_events: int = 50_000_000) -> float:
        n = 0
        heap = self._heap
        while heap and n < max_events:
            if until is not None and heap[0][0] > until:
                break
            t, _, fn, args = heapq.heappop(heap)
            self._t = t
            fn(*args)
            n += 1
            if stop_when is not None and n % 64 == 0 and stop_when():
                break
        self.events_processed += n
        return self._t

    def run_batched(self, until: Optional[float] = None,
                    stop_when: Optional[Callable[[], bool]] = None,
                    tick_s: float = 0.25,
                    on_tick: Optional[Callable[[float], None]] = None,
                    max_events: int = 50_000_000) -> float:
        """Batched-delivery mode: drain every due event up to the next
        tick boundary in one burst, then call `on_tick(now)` (the
        SwarmHub's batched decision pass) at the boundary.

        Shares `run()`'s heap, its single monotonic `_seq` counter and
        the `events_processed` total, so the two modes can interleave
        freely — same-tick events keep their insertion order no matter
        which mode pops them, and with `on_tick=None` this produces a
        trace identical to `run()` pop for pop (the mixed-mode
        determinism regression test asserts exactly that).

        Events scheduled *during* a burst at times inside the current
        tick are drained in the same burst, so intra-tick message
        cascades behave as in per-message mode; only the on_tick hook
        itself runs at quantized times.

        Wall time is split into `batched_drain_s` (message bursts: the
        per-event host-Python cost) and `batched_tick_s` (the on_tick
        decision passes) so `swarm_bench --profile` can report where a
        batched run actually spends its time."""
        n = 0
        heap = self._heap
        tick = max(float(tick_s), 1e-9)
        stop = False
        perf = time.perf_counter
        while heap and n < max_events and not stop:
            t0 = heap[0][0]
            if until is not None and t0 > until:
                break
            boundary = t0 + tick
            if until is not None:
                boundary = min(boundary, until)
            w0 = perf()
            while heap and heap[0][0] <= boundary and n < max_events:
                t, _, fn, args = heapq.heappop(heap)
                self._t = t
                fn(*args)
                n += 1
                if stop_when is not None and n % 64 == 0 and stop_when():
                    stop = True
                    break
            self.batched_drain_s += perf() - w0
            if stop:
                break
            if on_tick is not None:
                self._t = max(self._t, boundary)
                w0 = perf()
                on_tick(self._t)
                self.batched_tick_s += perf() - w0
                if stop_when is not None and stop_when():
                    break
        self.events_processed += n
        return self._t


# --------------------------------------------------------------------------- #
class ThreadRuntime(Runtime):
    """Real-time event loop: one dispatcher thread + a worker pool."""

    def __init__(self, n_workers: int = 4):
        self.nodes: Dict[str, Node] = {}
        self._q: "queue.Queue" = queue.Queue()
        # (due, seq, (node, name), delay, periodic, version)
        self._timers: List[Tuple[float, int, Tuple[str, str], float,
                                 bool, int]] = []
        self._timer_lock = threading.Lock()
        # version-counter cancellation (see SimRuntime): one entry per
        # live timer key instead of an ever-growing tombstone set
        self._timer_ver: Dict[Tuple[str, str], int] = {}
        self._seq = itertools.count()
        self._stop = threading.Event()
        self._work_q: "queue.Queue" = queue.Queue()
        self._cancelled_work: set = set()
        self._work_lock = threading.Lock()
        self._threads: List[threading.Thread] = []
        self.n_workers = n_workers
        self._t0 = time.monotonic()
        # run-generation token: threads spawned by an earlier run() exit
        # when a newer run starts, instead of surviving a timed-out join
        # and double-consuming the queues
        self._gen = 0

    def add_node(self, node: Node, speed: float = 1.0) -> None:
        self.nodes[node.node_id] = node
        node.start(self)

    def now(self) -> float:
        return time.monotonic() - self._t0

    def send(self, dst: str, msg: Msg) -> None:
        self._q.put(("msg", dst, msg))

    def set_timer(self, node_id: str, name: str, delay_s: float,
                  periodic: bool = False) -> None:
        key = (node_id, name)
        with self._timer_lock:
            ver = self._timer_ver.get(key, 0) + 1
            self._timer_ver[key] = ver
            heapq.heappush(self._timers,
                           (self.now() + delay_s, next(self._seq), key,
                            delay_s, periodic, ver))

    def cancel_timer(self, node_id: str, name: str) -> None:
        key = (node_id, name)
        with self._timer_lock:
            self._timer_ver[key] = self._timer_ver.get(key, 0) + 1

    def submit_work(self, node_id: str, tag: Any, fn: Callable[[], Any],
                    sim_duration_s: Optional[float] = None) -> None:
        self._work_q.put((node_id, tag, fn))

    def cancel_work(self, node_id: str, tag: Any) -> bool:
        """Mark queued work cancelled.  A worker that pops a cancelled job
        skips execution and delivers the CANCELLED sentinel instead; work
        already executing cannot be stopped.  Always returns False — the
        caller must discard the eventual (sentinel or real) result."""
        with self._work_lock:
            self._cancelled_work.add((node_id, tag))
        return False

    # -- loop --------------------------------------------------------------
    def _worker(self, gen: int):
        while not self._stop.is_set() and gen == self._gen:
            try:
                node_id, tag, fn = self._work_q.get(timeout=0.05)
            except queue.Empty:
                continue
            with self._work_lock:
                cancelled = (node_id, tag) in self._cancelled_work
                self._cancelled_work.discard((node_id, tag))
            if cancelled:
                self._q.put(("done", node_id, (tag, CANCELLED, 0.0)))
                continue
            t0 = self.now()
            result = fn() if fn is not None else None
            with self._work_lock:
                # consume a cancel that arrived mid-execution: the mark
                # must not outlive this job and falsely cancel a future
                # submission reusing the same tag
                self._cancelled_work.discard((node_id, tag))
            self._q.put(("done", node_id, (tag, result, self.now() - t0)))

    def _fire_due_timers(self) -> None:
        fired = []
        with self._timer_lock:
            while self._timers and self._timers[0][0] <= self.now():
                t, _, key, delay, periodic, ver = heapq.heappop(
                    self._timers)
                if self._timer_ver.get(key) != ver:
                    continue        # cancelled or superseded by a re-set
                fired.append(key)
                if periodic:
                    # re-arm from the *scheduled* time, not the (late) fire
                    # time, so periodic timers keep their grid instead of
                    # drifting by the handling latency every period; when
                    # overloaded past a full period, skip the missed slots
                    # (re-arming at <= now would re-fire in this same pass)
                    nt = t + delay
                    if nt <= self.now():
                        nt = self.now() + delay
                    heapq.heappush(self._timers,
                                   (nt, next(self._seq), key,
                                    delay, periodic, ver))
        for nid, name in fired:
            node = self.nodes.get(nid)
            if node:
                node.on_timer(name)

    def _dispatch(self, gen: int):
        while not self._stop.is_set() and gen == self._gen:
            # deadline-aware wait: block on the message queue only until
            # the next timer is due, and re-check timers after every
            # message, so a loaded queue cannot starve or drift timers
            self._fire_due_timers()
            with self._timer_lock:
                deadline = self._timers[0][0] if self._timers else None
            wait = 0.05 if deadline is None else deadline - self.now()
            if wait <= 0.0:
                continue
            try:
                kind, dst, data = self._q.get(timeout=min(wait, 0.05))
            except queue.Empty:
                continue
            node = self.nodes.get(dst)
            if node is None:
                continue
            if kind == "msg":
                node.on_message(data)
            else:
                tag, result, dt = data
                node.on_work_done(tag, result, dt)

    def run(self, until_s: float = 30.0,
            stop_when: Optional[Callable[[], bool]] = None) -> None:
        """Drive the loop for up to `until_s`.  Re-entrant: a second call
        restarts the worker/dispatcher threads, so tests can run phases
        (e.g. seed an image, add a node, run again)."""
        for th in self._threads:         # previous phase's threads
            th.join(timeout=1.0)
        self._gen += 1                   # orphans (stuck in a long fn)
        gen = self._gen                  # exit once their job finishes
        self._stop.clear()
        self._threads = []
        for _ in range(self.n_workers):
            th = threading.Thread(target=self._worker, args=(gen,),
                                  daemon=True)
            th.start()
            self._threads.append(th)
        disp = threading.Thread(target=self._dispatch, args=(gen,),
                                daemon=True)
        disp.start()
        self._threads.append(disp)
        deadline = time.monotonic() + until_s
        while time.monotonic() < deadline:
            if stop_when is not None and stop_when():
                break
            time.sleep(0.02)
        self._stop.set()
        for th in self._threads:
            th.join(timeout=1.0)
