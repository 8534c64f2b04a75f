"""ChaosScenario: seeded fault-injection runs of the live swarm protocol.

One class builds the standard chaos experiment — tracker + origin host +
N volunteers leeching a swarm application over a SimRuntime with a
`FaultPlan` (core.faults): lossy links, duplicated/reordered messages,
timed partitions and volunteer crash/restart churn.  Crashed volunteers
restart as *fresh incarnations* (restart factories), so volatile state
dies with them and only an on-disk piece cache (when `root_dir` is set)
survives into the piece-cache rescan path.

`check_invariants()` asserts the convergence properties every fault trace
must preserve:

  * the application completes and every surviving volunteer converges to
    the byte-identical image (manifest-hash identity for synthetic ones);
  * no part is ever decided by a quorum larger than m_min + 1;
  * the incremental availability bookkeeping equals a naive recompute
    from the stored peer masks at every surviving node.

In batched mode the shared `SwarmHub` runs on `device` ("cuda", the
default: the Hopper kernels; "cpu": their plain PyTorch versions).
A batched scenario on a machine without CUDA raises unless the caller
asks for the CPU; nothing falls back.  Besides the reference's
invariants, a batched run checks that every device plane the kernels
read equals the host array it mirrors once the planes are synced.

Counterpart of `repro.core.chaos`, decision for decision.  Used by
`repro_torch.scenarios.scenario_viii` and the chip smoke run.  A failing
seed reproduces with:
  PYTHONPATH=src python -m repro_torch.core.chaos --seed N --check
  (add --batched --device cpu|cuda for the batched path)
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional

from repro_torch.core.agent import Agent, AgentConfig
from repro_torch.core.faults import Crash, FaultPlan, LinkFault, Partition
from repro_torch.core.runtime import LinkModel, SimRuntime
from repro_torch.core.swarm_arrays import SwarmHub, SwarmState
from repro_torch.core.topology import Topology
from repro_torch.core.tracker_server import TrackerConfig, TrackerServer
from repro_torch.core.workunit import make_prime_app


def make_chaos_plan(seed: int, volunteers: List[str], *,
                    horizon_s: float,
                    loss: float = 0.10, dup: float = 0.02,
                    jitter_s: float = 0.2, churn: float = 0.25,
                    n_partitions: int = 1,
                    partition_s: float = 20.0,
                    partition_groups: Optional[List[frozenset]] = None
                    ) -> FaultPlan:
    """Derive a FaultPlan from a seed and a few knobs.  All randomness
    comes from `random.Random(seed)`, so (seed, knobs) pins the plan:
    `churn` of the volunteers crash inside the first ~45% of `horizon_s`
    and restart after an outage of up to 20% of it; each partition
    isolates a random island of volunteers for `partition_s`.  When
    `partition_groups` is given (e.g. the node sets of a Topology's
    islands), every partition isolates one of those groups instead — the
    worst case for cost-biased selection, since a partitioned ISP island
    is exactly the peer set P4P steers its members toward."""
    rng = random.Random(seed)
    crashes = []
    n_crash = int(round(churn * len(volunteers)))
    for node in rng.sample(volunteers, n_crash):
        # churn concentrated in the distribution phase: crashes land in
        # the first ~45% of the horizon with outages up to 20% of it, so
        # every restart still fights the swarm while it is moving pieces
        at = rng.uniform(0.05, 0.45) * horizon_s
        outage = rng.uniform(0.05, 0.20) * horizon_s
        crashes.append(Crash(node, at, at + outage))
    partitions = []
    for _ in range(n_partitions):
        start = rng.uniform(0.1, 0.5) * horizon_s
        if partition_groups:
            island = frozenset(rng.choice(partition_groups))
        else:
            k = rng.randint(1, max(1, len(volunteers) // 4))
            island = frozenset(rng.sample(volunteers, k))
        partitions.append(Partition(start, start + partition_s, (island,)))
    return FaultPlan(seed=seed,
                     link=LinkFault(drop_p=loss, dup_p=dup,
                                    jitter_s=jitter_s),
                     partitions=partitions, crashes=crashes)


def _chaos_image(nbytes: int) -> bytes:
    return bytes((i * 89 + 17) % 256 for i in range(nbytes))


class ChaosScenario:
    """Build, run and verify one seeded chaos experiment."""

    APP_ID = "chaos"

    def __init__(self, seed: int = 0, *,
                 n_volunteers: int = 12, n_pieces: int = 16,
                 n_parts: int = 24, m_min: int = 2,
                 image_bytes: int = 160_000, real_image: bool = True,
                 loss: float = 0.10, dup: float = 0.02,
                 jitter_s: float = 0.2, churn: float = 0.25,
                 n_partitions: int = 1, partition_s: float = 20.0,
                 horizon_s: float = 120.0, until_s: float = 4000.0,
                 uplink_mbps: float = 100.0,
                 sim_time_per_number: float = 2e-3,
                 root_dir: Optional[str] = None,
                 plan: Optional[FaultPlan] = None,
                 batched: bool = False, tick_s: float = 0.5,
                 device="cuda",
                 n_islands: int = 0,
                 island_partitions: bool = False,
                 wan_trunk_Bps: Optional[float] = None):
        self.seed = seed
        self.m_min = m_min
        self.until_s = until_s
        self.tick_s = tick_s
        # batched mode: all PieceExchanges share a SwarmHub and the run
        # drives SimRuntime.run_batched — the array-native path under the
        # same fault plan (piece traffic still crosses the faulty links)
        self.hub = SwarmHub(device=device) if batched else None
        self.vol_ids = [f"V{i:02d}" for i in range(n_volunteers)]
        # topology overlay: islands + WAN latencies under the
        # same fault plan; peer selection goes P4P via the tracker's
        # COST_MAP and (batched) the hub's cost-aware kernels
        self.topology = None
        if n_islands > 0:
            self.topology = Topology.make(["host"] + self.vol_ids,
                                          n_islands, seed=seed,
                                          trunk_Bps=wan_trunk_Bps)
        groups = None
        if island_partitions and self.topology is not None:
            by_isl: Dict[int, set] = {}
            for nid in self.vol_ids:
                by_isl.setdefault(self.topology.island_of(nid),
                                  set()).add(nid)
            groups = [frozenset(g) for _, g in sorted(by_isl.items())
                      if g]
        self.plan = plan if plan is not None else make_chaos_plan(
            seed, self.vol_ids, horizon_s=horizon_s, loss=loss, dup=dup,
            jitter_s=jitter_s, churn=churn, n_partitions=n_partitions,
            partition_s=partition_s, partition_groups=groups)
        self._perma_dead = {c.node for c in self.plan.crashes
                           if c.restart_s is None}
        link_Bps = uplink_mbps * 1e6 / 8
        self.rt = SimRuntime(link=LinkModel(uplink_Bps=link_Bps,
                                            downlink_Bps=link_Bps),
                             faults=self.plan, topology=self.topology)
        if self.hub is not None:
            # authoritative liveness for the shared arrays: reset a
            # crashed node's row at crash time, not on (possibly stale)
            # PEER_GONE relays that may trail its restart
            self.rt.crash_hooks.append(self.hub.node_gone)
            if self.topology is not None:
                self.hub.set_topology(self.topology)
        self.rt.add_node(TrackerServer(
            config=TrackerConfig(ping_interval_s=2.0),
            topology=self.topology))
        self.server = self.rt.nodes["server"]
        # recovery timescales sized to the fault model: leases must expire
        # well before a lost RESULT costs a makespan-visible stall, piece
        # re-requests faster still, and gossip/re-registration in between
        self._cfg = dict(work_timeout_s=10.0, status_interval_s=1.0,
                         rechoke_interval_s=5.0, piece_timeout_s=5.0,
                         reregister_s=15.0, gossip_interval_s=5.0,
                         replicate_completed=True, root_dir=root_dir)
        self.incarnations: Dict[str, List[Agent]] = {}
        self.host = self._make_agent("host")
        self.rt.add_node(self.host)
        self.image = _chaos_image(image_bytes) if real_image else None
        self.app = make_prime_app(
            self.APP_ID, "host", 3, 1000 * n_parts, n_parts=n_parts,
            sim_time_per_number=sim_time_per_number, m_min=m_min,
            swarm=True, app_bytes=image_bytes,
            piece_bytes=max(image_bytes // n_pieces, 1), image=self.image)
        self.host.host_app(self.app)
        for i, nid in enumerate(self.vol_ids):
            self.rt.add_node(self._make_agent(nid),
                             speed=1.0 - 0.3 * i / max(n_volunteers, 1))
            # crash-restarts build a fresh incarnation: volatile state is
            # lost, only the on-disk piece cache (root_dir) survives
            self.rt.restart_factory[nid] = \
                lambda n=nid: self._make_agent(n)
        self.makespan_s: Optional[float] = None

    def _make_agent(self, node_id: str) -> Agent:
        a = Agent(node_id, config=AgentConfig(**self._cfg), hub=self.hub)
        self.incarnations.setdefault(node_id, []).append(a)
        return a

    # ------------------------------------------------------------------ #
    def volunteers(self) -> List[Agent]:
        """Currently-live volunteer incarnations."""
        return [self.rt.nodes[nid] for nid in self.vol_ids
                if nid in self.rt.nodes]

    def _converged(self) -> bool:
        if not self.app.done:
            return False
        for nid in self.vol_ids:
            if nid in self._perma_dead:
                continue
            node = self.rt.nodes.get(nid)       # None while crashed
            if node is None or self.APP_ID not in node.images:
                return False
        return True

    def run(self) -> "ChaosScenario":
        if self.hub is not None:
            self.rt.run_batched(until=self.until_s,
                                stop_when=self._converged,
                                tick_s=self.tick_s, on_tick=self.hub.tick)
        else:
            self.rt.run(until=self.until_s, stop_when=self._converged)
        self.makespan_s = self.rt.now()
        return self

    # ------------------------------------------------------------------ #
    def _fail(self, what: str) -> str:
        return (f"[chaos seed={self.seed}] {what} — repro: "
                f"PYTHONPATH=src python -m repro_torch.core.chaos "
                f"--seed {self.seed} --check")

    def check_invariants(self) -> None:
        """Assert the convergence/quorum/availability invariants; failure
        messages carry the seed for a one-line repro."""
        assert self.app.done, self._fail("application never completed")
        survivors = self.volunteers()
        manifest_hash = self.app.manifest.manifest_hash
        for a in survivors:
            assert self.APP_ID in a.images, \
                self._fail(f"{a.node_id} never replicated the image")
            assert a.images[self.APP_ID] == manifest_hash, \
                self._fail(f"{a.node_id} holds a different image")
            if self.image is not None:
                got = a.px.assembled_image(self.APP_ID)
                assert got == self.image, \
                    self._fail(f"{a.node_id} image not byte-identical")
        # no part was ever decided by more than m_min + 1 voters, at any
        # seeder incarnation that existed during the run
        for incs in self.incarnations.values():
            for a in incs:
                for (app_id, part_id), q in a.quorum_sizes.items():
                    assert q <= self.m_min + 1, self._fail(
                        f"{a.node_id} part {part_id} quorum {q} "
                        f"> m_min+1={self.m_min + 1}")
        # incremental availability equals the naive recompute after the
        # fault trace (the incremental fast path must not drift under chaos)
        for a in survivors + [self.host]:
            for app_id in list(a.px._counts):
                arr = a.px.avail_array(app_id)
                naive = a.px._avail_naive(app_id)
                for p in range(len(arr)):
                    assert int(arr[p]) == naive[p], self._fail(
                        f"{a.node_id} availability drift at piece {p}: "
                        f"incremental {int(arr[p])} != naive {naive[p]}")
        # batched mode: the shared arrays must agree with themselves and
        # with every live engine's verified inventory after the trace
        if self.hub is not None:
            for st in self.hub.states.values():
                n = st.n
                bad = stale_planes(st)
                assert not bad, self._fail(
                    f"device planes {bad} of {st.app_id} v"
                    f"{st.manifest.version} trail their host arrays")
                col_sums = st.have[:n].sum(axis=0, dtype=int)
                for p in range(st.P):
                    assert int(st.counts[p]) == int(col_sums[p]), \
                        self._fail(f"hub count drift at piece {p}: "
                                   f"{int(st.counts[p])} != "
                                   f"{int(col_sums[p])}")
                for a in survivors:
                    i = st.row.get(a.node_id)
                    if i is None or st.clients[i] is not a.px:
                        continue
                    inv = a.px.inventories.get(st.app_id)
                    if inv is None:
                        continue
                    row_have = {p for p in range(st.P) if st.have[i, p]}
                    assert row_have == set(inv.have), self._fail(
                        f"hub row for {a.node_id} disagrees with its "
                        f"inventory")
                # the in-flight array ledger must mirror every
                # live engine's scalar pending dicts entry for entry after
                # the fault trace; dead/detached rows must be fully swept
                for name, i in st.row.items():
                    px_i = st.clients[i]
                    if px_i is None or not st.alive[i]:
                        assert int(st.pend_n[i]) == 0 \
                            and int(st.busy_n[i]) == 0, self._fail(
                                f"ledger not swept for dead row {name}")
                        continue
                    pending = px_i.pending.get(st.app_id, {})
                    assert int(st.pend_n[i]) == len(pending), self._fail(
                        f"ledger piece count drift for {name}")
                    for p, asked in pending.items():
                        cnt = int(st.pend_cnt[i, p])
                        assert cnt == len(asked), self._fail(
                            f"ledger slot count drift {name} piece {p}")
                        named = {}
                        for s in range(cnt):
                            j = int(st.pend_holder[i, p, s])
                            if j >= 0:
                                named[st.names[j]] = float(st.pend_t[i, p,
                                                                     s])
                        want = {h: float(t) for h, t in asked.items()
                                if h in st.row}
                        assert named == want, self._fail(
                            f"ledger holder drift {name} piece {p}")
        # version discipline: no engine ever accepted a stale piece
        for a in survivors + [self.host]:
            assert a.px.stale_accepts == 0, self._fail(
                f"{a.node_id} accepted {a.px.stale_accepts} stale pieces")

    def report(self) -> dict:
        rt = self.rt
        if self.hub is not None:
            hub_stats = self.hub.stats()
        else:
            hub_stats = {}
        return {
            "seed": self.seed,
            **hub_stats,
            "done": self.app.done,
            "replicated": self._converged(),
            "makespan_s": self.makespan_s if self.makespan_s is not None
            else rt.now(),
            "replicas": sum(1 for a in self.volunteers()
                            if self.APP_ID in a.images),
            "origin_up_mb": rt.tx_bytes.get("host", 0) / 1e6,
            "cross_isp_bytes": rt.cross_isp_bytes,
            "dropped_msgs": rt.dropped_msgs,
            "dup_msgs": rt.dup_msgs,
            "crashes": rt.crash_count,
            "restarts": rt.restart_count,
            "events": rt.events_processed,
        }


def stale_planes(st: SwarmState) -> List[str]:
    """Sync `st`'s device planes, then name every plane whose rows
    [:st.n] differ from the host array it mirrors: a host change made
    without `touch` (or a reset whose `touch` was lost) shows up here."""
    st.sync_planes()
    n = st.n
    bad = []
    for plane, host in SwarmState._PLANES.items():
        got = getattr(st, plane)[:n].cpu().numpy()
        if not (got == getattr(st, host)[:n].astype(got.dtype)).all():
            bad.append(plane)
    return bad


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--volunteers", type=int, default=12)
    ap.add_argument("--loss", type=float, default=0.10)
    ap.add_argument("--jitter", type=float, default=0.2)
    ap.add_argument("--churn", type=float, default=0.25)
    ap.add_argument("--partitions", type=int, default=1)
    ap.add_argument("--check", action="store_true",
                    help="assert the chaos invariants after the run")
    ap.add_argument("--batched", action="store_true",
                    help="run the array-native batched swarm path")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the batched hub's device (cpu: the kernels' "
                         "plain PyTorch versions)")
    ap.add_argument("--islands", type=int, default=0,
                    help="WAN islands (0 = flat); partitions align with "
                         "island boundaries when set")
    args = ap.parse_args(argv)
    sc = ChaosScenario(seed=args.seed, n_volunteers=args.volunteers,
                       loss=args.loss, jitter_s=args.jitter,
                       churn=args.churn, n_partitions=args.partitions,
                       batched=args.batched, device=args.device,
                       n_islands=args.islands,
                       island_partitions=args.islands > 0)
    sc.run()
    print(sc.report())
    if args.check:
        sc.check_invariants()
        print(f"[chaos] seed={args.seed}: invariants OK")


if __name__ == "__main__":
    main()
