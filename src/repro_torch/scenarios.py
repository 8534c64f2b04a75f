"""Scenario runs of the batched flash-crowd loop on `repro_torch`.

`scenario_vii` (flash crowd) and `scenario_ix` (topology-aware P4P peer
selection on a WAN) are the reference's `benchmarks/paper_tables.py`
functions of the same names, unchanged in behaviour, with `device=` in
place of `backend=`: the batched hub runs its kernels on that device
("cuda" by default; "cpu" takes the plain PyTorch versions) and the
result reports it under "device".  Virtual-time results (`makespan_s`,
`full_replication_s`, `p99_completion_s`, `cross_isp_bytes`,
`origin_up_mb`, `events`) are the reference's bit for bit under the same
`PYTHONHASHSEED`: the protocol iterates sets of node names, so their
order — and with it the trace — follows the process's string hash seed.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core import (Agent, AgentConfig, SimRuntime, TrackerConfig,
                              TrackerServer, make_prime_app)
from repro_torch.core.runtime import LinkModel
from repro_torch.core.swarm_arrays import SwarmHub
from repro_torch.core.topology import Topology

H = 3600.0


def scenario_vii(verbose: bool = True, n_volunteers: int = 200,
                 image_mb: float = 64.0, n_pieces: int = 64,
                 n_parts: Optional[int] = None, m_min: int = 1,
                 uplink_mbps: float = 100.0, until_h: float = 8.0,
                 batched: bool = False, tick_s: float = 0.5,
                 device="cuda") -> dict:
    """Scenario VII: flash crowd at production-ish scale (default N=200).

    The paper validates the protocol on six nodes; BOINC-class deployments
    (PAPERS.md) run orders of magnitude more.  Here every volunteer joins
    the swarm at t=0 — the worst case for the origin's uplink and for the
    simulator's bookkeeping, since each verified piece triggers O(N) HAVE
    announces.  Reports protocol metrics (makespan, origin egress) AND
    simulator throughput (events/sec, peak RSS), so BENCH_swarm.json
    tracks both the protocol's scaling and the simulator's perf
    trajectory.  Only feasible since the PieceExchange bookkeeping went
    incremental: the pre-optimization engine rebuilt an O(pieces × peers)
    availability map per pump and capped practical runs at N≈24.

    `batched=True` switches to the array-native path (core/swarm_arrays)
    on `device` ("cuda": the Hopper kernels; "cpu": their plain PyTorch
    versions):
    one shared SwarmHub makes all piece/choke decisions in batched
    per-tick kernel passes and the control plane moves through the arrays
    instead of O(N^2) wire messages — the mode that reaches N=2000.  In
    batched mode `events` counts heap pops only; `logical_events` adds
    the control-plane deliveries the arrays replaced, and both rates are
    reported (`events_per_sec` is logical, `heap_events_per_sec` raw).
    """
    import resource
    import time as _time


    if n_parts is None:
        n_parts = 2 * n_volunteers
    image_bytes = int(image_mb * 1e6)
    link_Bps = uplink_mbps * 1e6 / 8
    rt = SimRuntime(link=LinkModel(uplink_Bps=link_Bps,
                                   downlink_Bps=link_Bps))
    rt.add_node(TrackerServer(config=TrackerConfig(ping_interval_s=5.0)))
    cfg = dict(work_timeout_s=600.0, status_interval_s=5.0,
               rechoke_interval_s=5.0)
    hub = None
    if batched:
        hub = SwarmHub(device=device)
        rt.crash_hooks.append(hub.node_gone)
        # at flash-crowd scale, cap the replica *seeder* set: seeders
        # beyond a handful add tracker/gossip bookkeeping, not download
        # capacity (every completed volunteer still serves pieces)
        cfg["max_replica_seeders"] = 8
    host = Agent("host", config=AgentConfig(**cfg), hub=hub)
    rt.add_node(host)
    app = make_prime_app("appvii", "host", 3, 48_000, n_parts=n_parts,
                         sim_time_per_number=2e-3, m_min=m_min, swarm=True,
                         app_bytes=image_bytes,
                         piece_bytes=image_bytes // n_pieces)
    host.host_app(app)
    agents = [host]
    for i in range(n_volunteers):
        a = Agent(f"V{i:03d}", config=AgentConfig(**cfg), hub=hub)
        # heterogeneous volunteer speeds, as in Scenario IV/VI
        rt.add_node(a, speed=1.0 - 0.4 * i / max(n_volunteers, 1))
        agents.append(a)

    def _run(until, stop_when):
        if hub is not None:
            return rt.run_batched(until=until, stop_when=stop_when,
                                  tick_s=tick_s, on_tick=hub.tick)
        return rt.run(until=until, stop_when=stop_when)

    t0 = _time.perf_counter()
    # phase 1 — work: cheap O(1) stop probe; the host records completion
    # the moment the last part validates (directly or via PART_DONE gossip)
    _run(until_h * H, lambda: "appvii" in host.completed_at)
    work_done_s = rt.now()
    # phase 2 — full replication: the flash crowd ends when every
    # volunteer holds the verified image (the swarm keeps moving pieces
    # after the work drains); the probe list shrinks as volunteers finish
    # volunteers are appended fastest-first (speed 1.0 - 0.4*i/N), so the
    # list tail finishes last: popping finished agents off the tail keeps
    # the probe amortized O(1) — the run_batched loop calls it every 64
    # drained events, and a full list scan there is O(N) per call (the
    # dominant superlinear drain cost at N=10000 before this change)
    not_done = list(agents[1:])

    def all_replicated():
        while not_done and "appvii" in not_done[-1].images:
            not_done.pop()
        return not not_done

    _run(until_h * H, all_replicated)
    wall_s = max(_time.perf_counter() - t0, 1e-9)
    events = rt.events_processed
    coalesced = hub.coalesced if hub is not None else 0
    logical = events + coalesced
    replicas = sum(1 for a in agents[1:] if "appvii" in a.images)
    # p99 of the per-node image-completion distribution (stragglers that
    # never finished count as run end); cross_isp_bytes is 0 on this flat
    # scenario but keeps the row schema aligned with Scenario IX
    times = sorted(a.image_completed_at.get("appvii", rt.now())
                   for a in agents[1:])
    p99 = times[min(int(0.99 * (len(times) - 1)), len(times) - 1)] \
        if times else 0.0
    res = {
        "n_volunteers": n_volunteers,
        "image_mb": image_mb,
        "batched": batched,
        "done": "appvii" in host.completed_at,
        "makespan_s": work_done_s,
        "full_replication_s": rt.now(),
        "p99_completion_s": p99,
        "cross_isp_bytes": rt.cross_isp_bytes,
        "replicated": replicas == n_volunteers,
        "origin_up_mb": rt.tx_bytes.get("host", 0) / 1e6,
        "replicas": replicas,
        "events": events,
        "logical_events": logical,
        "events_per_sec": logical / wall_s,
        "heap_events_per_sec": events / wall_s,
        "nodes_per_sec": (n_volunteers + 1) / wall_s,
        "wall_s": wall_s,
        "peak_rss_mb": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 1024.0,
    }
    if hub is not None:
        res.update(hub.stats())
        res["device"] = str(hub.device)
        # host-Python wall split from the runtime: message-burst drains
        # vs the batched on_tick decision passes
        res["drain_wall_s"] = rt.batched_drain_s
    if verbose:
        mode = " batched" if batched else ""
        print(f"[scenarioVII{mode}] N={n_volunteers} "
              f"img={image_mb:.0f}MB: "
              f"makespan={res['makespan_s']:.0f}s "
              f"replication={res['full_replication_s']:.0f}s "
              f"origin_up={res['origin_up_mb']:.0f}MB "
              f"replicas={res['replicas']} done={res['done']} | sim: "
              f"{res['logical_events']} logical events "
              f"({res['events']} heap) in {res['wall_s']:.1f}s "
              f"({res['events_per_sec']:.0f}/s) "
              f"peak_rss={res['peak_rss_mb']:.0f}MB")
    return res


def scenario_ix(verbose: bool = True, n_volunteers: int = 500,
                n_islands: int = 8, image_mb: float = 32.0,
                n_pieces: int = 64, n_parts: Optional[int] = None,
                m_min: int = 1, uplink_mbps: float = 100.0,
                until_h: float = 8.0, tick_s: float = 0.5,
                seed: int = 9, trunk_Bps: Optional[float] = None,
                device="cuda") -> dict:
    """Scenario IX: topology-aware (P4P) peer selection on a WAN.

    Fixed total demand — the Scenario VII flash crowd, N volunteers
    spread round-robin across `n_islands` ISP islands with seeded
    inter-island latencies — run twice on the *identical* topology:

      * ``naive`` — rarity-only selection: the WAN is there (every
        cross-island message pays the latency, every cross-island byte is
        counted) but peers ignore it, the topology-blind behaviour;
      * ``p4p``   — the tracker serves its ALTO COST_MAP and the batched
        engine folds the cost plane into piece and holder selection
        (same-island holders first, rarity within a cost class).

    Headline metrics: **cross-ISP bytes** (the economics BOINC-scale
    swarms actually pay for) and **p99 node-completion time** (WAN tail
    latency).  Target: >=5x cross-ISP cut with <=5% work-makespan
    regression.  Rows land in BENCH_swarm.json, guarded by bench_guard.
    """
    import time as _time

    if n_parts is None:
        n_parts = 2 * n_volunteers
    image_bytes = int(image_mb * 1e6)
    link_Bps = uplink_mbps * 1e6 / 8
    app_id = "appix"
    vol_ids = [f"V{i:03d}" for i in range(n_volunteers)]

    def _one(p4p: bool) -> dict:
        topo = Topology.make(["host"] + vol_ids, n_islands, seed=seed,
                             trunk_Bps=trunk_Bps)
        rt = SimRuntime(link=LinkModel(uplink_Bps=link_Bps,
                                       downlink_Bps=link_Bps),
                        topology=topo)
        rt.add_node(TrackerServer(
            config=TrackerConfig(ping_interval_s=5.0),
            topology=topo if p4p else None))
        hub = SwarmHub(device=device)
        rt.crash_hooks.append(hub.node_gone)
        if p4p:
            hub.set_topology(topo)
        cfg = dict(work_timeout_s=600.0, status_interval_s=5.0,
                   rechoke_interval_s=5.0, max_replica_seeders=8)
        host = Agent("host", config=AgentConfig(**cfg), hub=hub)
        rt.add_node(host)
        app = make_prime_app(app_id, "host", 3, 48_000, n_parts=n_parts,
                             sim_time_per_number=2e-3, m_min=m_min,
                             swarm=True, app_bytes=image_bytes,
                             piece_bytes=image_bytes // n_pieces)
        host.host_app(app)
        agents = []
        for i, nid in enumerate(vol_ids):
            a = Agent(nid, config=AgentConfig(**cfg), hub=hub)
            rt.add_node(a, speed=1.0 - 0.4 * i / max(n_volunteers, 1))
            agents.append(a)
        t0 = _time.perf_counter()
        rt.run_batched(until=until_h * H,
                       stop_when=lambda: app_id in host.completed_at,
                       tick_s=tick_s, on_tick=hub.tick)
        work_done_s = rt.now()
        not_done = list(agents)

        def all_replicated():
            not_done[:] = [a for a in not_done if app_id not in a.images]
            return not not_done

        rt.run_batched(until=until_h * H, stop_when=all_replicated,
                       tick_s=tick_s, on_tick=hub.tick)
        wall_s = max(_time.perf_counter() - t0, 1e-9)
        # per-node completion distribution: the sim time each volunteer
        # verified the full image; stragglers count as run end
        times = sorted(a.image_completed_at.get(app_id, rt.now())
                       for a in agents)
        p99 = times[min(int(0.99 * (len(times) - 1)), len(times) - 1)]
        replicas = sum(1 for a in agents if app_id in a.images)
        logical = rt.events_processed + hub.coalesced
        return {
            "mode": "p4p" if p4p else "naive",
            "done": app_id in host.completed_at,
            "replicated": replicas == n_volunteers,
            "replicas": replicas,
            "makespan_s": work_done_s,
            "full_replication_s": rt.now(),
            "p99_completion_s": p99,
            "cross_isp_bytes": rt.cross_isp_bytes,
            "origin_up_mb": rt.tx_bytes.get("host", 0) / 1e6,
            "events": rt.events_processed,
            "logical_events": logical,
            "events_per_sec": logical / wall_s,
            "wall_s": wall_s,
            "device": str(hub.device),
            **hub.stats(),
        }

    naive = _one(p4p=False)
    p4p = _one(p4p=True)
    res = {
        "n_volunteers": n_volunteers,
        "n_islands": n_islands,
        "image_mb": image_mb,
        "seed": seed,
        "naive": naive,
        "p4p": p4p,
        "cross_isp_reduction": naive["cross_isp_bytes"]
        / max(p4p["cross_isp_bytes"], 1),
        "makespan_ratio": p4p["makespan_s"]
        / max(naive["makespan_s"], 1e-9),
        "p99_ratio": p4p["p99_completion_s"]
        / max(naive["p99_completion_s"], 1e-9),
        "done": naive["done"] and p4p["done"],
        "replicated": naive["replicated"] and p4p["replicated"],
    }
    if verbose:
        print(f"[scenarioIX] N={n_volunteers} islands={n_islands} "
              f"img={image_mb:.0f}MB: cross-ISP "
              f"{naive['cross_isp_bytes'] / 1e6:.0f} -> "
              f"{p4p['cross_isp_bytes'] / 1e6:.0f}MB "
              f"({res['cross_isp_reduction']:.1f}x cut) "
              f"p99 {naive['p99_completion_s']:.0f} -> "
              f"{p4p['p99_completion_s']:.0f}s "
              f"makespan {naive['makespan_s']:.0f} -> "
              f"{p4p['makespan_s']:.0f}s "
              f"(x{res['makespan_ratio']:.3f}) "
              f"replicated={res['replicated']}")
    return res
