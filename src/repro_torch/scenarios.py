"""Scenario runs of the volunteer cloud and its swarm on `repro_torch`.

The reference's `benchmarks/paper_tables.py`, function for function:

- `table1`-`table4`: the source paper's Scenarios I-IV (Tables I-IV),
  2,000,000 to 3,000,000 integers on up to six volunteers, on the
  calibration at the top of this module; `scenario_v` (the piece-wise
  swarm against a single seeder, and origin failover), `scenario_vi`
  (choking and endgame cancels) and `scenario_xi` (a flash crowd of
  serving replicas cold-starting from a multi-GB checkpoint: origin-only
  against swarm, flat and on ISP islands, and the origin's death).  These
  are scalar protocol runs: no device is involved.
- `scenario_vii` (flash crowd), `scenario_viii` (chaos: loss,
  duplication, jitter, churn and a partition), `scenario_ix`
  (topology-aware P4P peer selection on a WAN) and `scenario_x`
  (versioned-manifest delta distribution), with `device=` in place of
  `backend=`: the batched hub runs its kernels on that device ("cuda" by
  default; "cpu" takes the plain PyTorch versions) and the result
  reports it under "device".  `scenario_viii` also takes `batched=` (the
  reference `ChaosScenario`'s own batched mode; off by default, as
  there).

Behaviour and printed lines are the reference's; each table's result
also carries its run's `ScenarioOut` under "scenario_out"
(`scenario_out_fields`).  Virtual-time results (`virtual_time_fields`:
makespans, cycles, per-cycle seconds, leeched MB, egress, events,
times to ready, cross-ISP bytes) are the reference's bit for bit under
the same `PYTHONHASHSEED`: the protocol iterates sets of node names, so
their order — and with it the trace — follows the process's string hash
seed.

    python -m repro_torch.scenarios [--device cpu] [name ...]

runs the named entries of `ALL_TABLES` (all of them by default) and
prints the reference's lines.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.core import (Agent, AgentConfig, ChaosScenario, SimRuntime,
                              TrackerConfig, TrackerServer, make_prime_app)
from repro_torch.core.runtime import LinkModel
from repro_torch.core.swarm_arrays import SwarmHub
from repro_torch.core.topology import Topology

H = 3600.0

# The virtual-time fields of each run's result, which the port must
# reproduce exactly; wall-clock fields (`wall_s`, `tick_wall_s`, ...)
# never compare.  "chaos" is one `ChaosScenario(...).report()`.
_FLASH_FIELDS = ("events", "makespan_s", "full_replication_s",
                 "p99_completion_s", "cross_isp_bytes", "origin_up_mb",
                 "replicas")
_CHAOS_FIELDS = ("makespan_s", "origin_up_mb", "events", "dropped_msgs",
                 "dup_msgs", "crashes", "restarts", "replicas",
                 "replicated", "done")
_X_FIELDS = ("v1_makespan_s", "upgrade_makespan_s", "scratch_makespan_s",
             "v1_traffic_bytes", "upgrade_traffic_bytes",
             "scratch_traffic_bytes", "reused_pieces", "stale_accepts",
             "upgraded", "replicated")
_X_CHAOS_FIELDS = ("converged", "reused_pieces", "stale_have_demoted",
                   "stale_piece_data", "stale_reqs_refused", "stale_accepts")


# the scalar runs: every field of their results is virtual time or
# derived from it
TABLES = ("table1", "table2", "table3", "table4")
SCALAR = TABLES + ("scenario_v", "scenario_vi", "scenario_xi")


def _spell(d: dict) -> dict:
    """`d` with its (app_id, node) tuple keys spelled "app_id/node"."""
    return {"/".join(k) if isinstance(k, tuple) else k: v
            for k, v in d.items()}


def virtual_time_fields(scenario: str, res: dict) -> dict:
    """The fields of `res`, a result of `scenario` (a name of
    `ALL_TABLES`, or "chaos"), that do not depend on the machine, in a
    JSON-safe spelling."""
    def pick(d, keys):
        return {k: d[k] for k in keys}

    if scenario in TABLES:
        return {k: _spell(v) if isinstance(v, dict) else v
                for k, v in res.items()}
    if scenario in SCALAR:
        return dict(res)
    if scenario == "scenario_vii":
        return pick(res, _FLASH_FIELDS)
    if scenario == "scenario_ix":
        return {arm: pick(res[arm], _FLASH_FIELDS) for arm in ("naive", "p4p")}
    if scenario == "scenario_viii":
        return {"baseline": pick(res["baseline"], _CHAOS_FIELDS),
                "chaos": pick(res["chaos"], _CHAOS_FIELDS),
                **pick(res, ("makespan_overhead", "egress_overhead"))}
    if scenario == "chaos":
        return pick(res, _CHAOS_FIELDS + ("cross_isp_bytes",))
    if scenario == "scenario_x":
        out = pick(res, _X_FIELDS)
        if "chaos" in res:
            out["chaos"] = pick(res["chaos"], _X_CHAOS_FIELDS)
        return out
    raise ValueError(f"unknown scenario {scenario!r}")


# ---------------- the paper's Tables I-IV (Scenarios I-IV) ----------------- #
# Calibration: app1 = primes 3..2,000,000 in 2059 parts (host-class
# per-cycle 4.93 s, VM-class 5.51 s: Table I's sequential rows); app2 =
# primes 2,000,000..3,000,000 in 1080 parts (21.21 s, 21.66 s: Table II's).
# The per-cycle protocol / VM overhead, 6.35 - 5.51 = 0.84 s, comes from
# Scenario I (parallel average against the sequential VM average) and is
# applied unchanged to all four tables, so II-IV are predictions.  The
# second machine class of Scenario IV (an i3 and its VMs) runs at ~8.1/10.8
# = 0.75 of the VM class.  The protocol (tracker, agents, leases, voting)
# runs for real on the discrete-event runtime; only the per-cycle compute
# cost is synthetic.

# paper-measured sequential per-cycle seconds
APP1 = dict(lo=3, hi=2_000_000, parts=2059, host_cycle=4.93, vm_cycle=5.51,
            data_mb=8.33)
APP2 = dict(lo=2_000_000, hi=3_000_000, parts=1080, host_cycle=21.21,
            vm_cycle=21.66, data_mb=4.23)
VM_SPEED = APP1["host_cycle"] / APP1["vm_cycle"]        # 0.895
I3_SPEED = VM_SPEED * 0.75                              # scenario IV machines
# per-cycle overhead in reference work units: VM-observed 0.84s x VM speed
OVERHEAD_S = (6.35 - 5.51) * VM_SPEED                   # 0.752


def _mk_app(app_id, host, spec, m_min=1):
    per_number = spec["host_cycle"] * spec["parts"] / (spec["hi"] - spec["lo"])
    n = spec["parts"]
    part_bytes = int(spec["data_mb"] * 2**20 / n)
    return make_prime_app(app_id, host, spec["lo"], spec["hi"], n,
                          app_bytes=4096, part_data_bytes=part_bytes,
                          m_min=m_min, sim_time_per_number=per_number)


@dataclass
class ScenarioOut:
    makespan_h: Dict[str, float]
    cycles: Dict[Tuple[str, str], int]
    avg_s: Dict[Tuple[str, str], float]
    data_mb: Dict[Tuple[str, str], float]
    host_metrics: Dict[str, dict]


def run_scenario(apps: dict, speeds: dict, self_leech: bool = False,
                 until_h: float = 48.0, m_min: int = 1) -> ScenarioOut:
    """apps: app_id -> (host_id, spec); speeds: node_id -> speed."""
    rt = SimRuntime()
    rt.add_node(TrackerServer(config=TrackerConfig(ping_interval_s=5.0)))
    agents = {}
    for nid, sp in speeds.items():
        a = Agent(nid, config=AgentConfig(
            work_timeout_s=600.0, status_interval_s=5.0,
            cycle_overhead_s=OVERHEAD_S, self_leech=self_leech,
            max_parallel_apps=2))
        agents[nid] = a
        rt.add_node(a, speed=sp)
    objs = {}
    for app_id, (host, spec) in apps.items():
        app = _mk_app(app_id, host, spec, m_min)
        agents[host].host_app(app)
        objs[app_id] = (app, agents[host])

    rt.run(until=until_h * H,
           stop_when=lambda: all(a.done for a, _ in objs.values()))

    out = ScenarioOut({}, {}, {}, {}, {})
    for app_id, (app, host) in objs.items():
        out.makespan_h[app_id] = host.completed_at.get(app_id, rt.now()) / H
        out.host_metrics[app_id] = host.metrics[app_id].as_dict()
        for nid, ag in agents.items():
            c = ag.completed_cycles.get(app_id, 0)
            if c:
                out.cycles[(app_id, nid)] = c
                out.avg_s[(app_id, nid)] = ag.leech_time[app_id] / c
                out.data_mb[(app_id, nid)] = ag.leech_bytes[app_id] / 2**20
    return out


def scenario_out_fields(out) -> dict:
    """A `ScenarioOut` (this module's or the reference's) as a JSON-safe
    dict: its (app_id, node) keys spelled "app_id/node"."""
    return {"makespan_h": dict(out.makespan_h), "cycles": _spell(out.cycles),
            "avg_s": _spell(out.avg_s), "data_mb": _spell(out.data_mb),
            "host_metrics": {k: dict(v) for k, v in out.host_metrics.items()}}


def table1(verbose: bool = True) -> dict:
    """Scenario I: three volunteers, one application."""
    out = run_scenario({"app1": ("Y", APP1)},
                       {"Y": VM_SPEED, "X": VM_SPEED, "Z": VM_SPEED})
    t = out.makespan_h["app1"]
    seq_host, seq_vm = 2.82, 3.15
    res = {
        "parallel_h": t,
        "speedup_vs_host": seq_host / t,
        "speedup_vs_vm": seq_vm / t,
        "paper_speedup_vs_host": 1.56,
        "paper_speedup_vs_vm": 1.73,
        "cycles": {n: out.cycles.get(("app1", n), 0) for n in ("X", "Z")},
        "paper_cycles": {"X": 1031, "Z": 1028},
        "avg_s": {n: out.avg_s.get(("app1", n), 0.0) for n in ("X", "Z")},
        "paper_avg_s": 6.35,
    }
    res["scenario_out"] = scenario_out_fields(out)
    if verbose:
        print(f"[table1] parallel={t:.2f}h (paper 1.82/1.81) "
              f"speedup host={res['speedup_vs_host']:.2f} (paper 1.56) "
              f"vm={res['speedup_vs_vm']:.2f} (paper 1.73) "
              f"cycles={res['cycles']} avg={res['avg_s']}")
    return res


def table2(verbose: bool = True) -> dict:
    """Scenario II: three volunteers, two applications.

    X hosts app1 (leeches app2); Z hosts app2 (leeches app1); Y leeches both.
    Paper headline: both apps complete ~33% faster than sequential app2."""
    out = run_scenario({"app1": ("X", APP1), "app2": ("Z", APP2)},
                       {"X": VM_SPEED, "Y": VM_SPEED, "Z": VM_SPEED})
    makespan = max(out.makespan_h.values())
    seq_app2_vm = 6.73
    res = {
        "makespan_h": makespan,
        "app1_h": out.makespan_h["app1"],
        "app2_h": out.makespan_h["app2"],
        "faster_than_seq_pct": 100.0 * (1 - makespan / seq_app2_vm),
        "paper_faster_pct": 33.0,
        "cycles": {k: v for k, v in out.cycles.items()},
        "paper_cycles": {("app1", "Y"): 139, ("app1", "Z"): 1920,
                         ("app2", "Y"): 462, ("app2", "X"): 618},
    }
    res["scenario_out"] = scenario_out_fields(out)
    if verbose:
        print(f"[table2] makespan={makespan:.2f}h (paper ~4.48) "
              f"faster={res['faster_than_seq_pct']:.0f}% (paper ~33%) "
              f"cycles={res['cycles']}")
    return res


def table3(verbose: bool = True) -> dict:
    """Scenario III: II + hosts also run their own applications."""
    out = run_scenario({"app1": ("X", APP1), "app2": ("Z", APP2)},
                       {"X": VM_SPEED, "Y": VM_SPEED, "Z": VM_SPEED},
                       self_leech=True)
    res = {
        "app1_h": out.makespan_h["app1"],
        "app2_h": out.makespan_h["app2"],
        "paper_app1_h": 2.88,     # slowest client row (Y)
        "paper_app2_h": 3.50,
        "cycles": dict(out.cycles),
        "paper_cycles": {("app1", "X"): 736, ("app1", "Y"): 635,
                         ("app1", "Z"): 688, ("app2", "X"): 401,
                         ("app2", "Y"): 329, ("app2", "Z"): 350},
    }
    res["scenario_out"] = scenario_out_fields(out)
    if verbose:
        print(f"[table3] app1={res['app1_h']:.2f}h (paper ~2.88) "
              f"app2={res['app2_h']:.2f}h (paper ~3.50) cycles-sum="
              f"{sum(v for (a, _), v in out.cycles.items() if a == 'app1')}/"
              f"{sum(v for (a, _), v in out.cycles.items() if a == 'app2')}")
    return res


def table4(verbose: bool = True) -> dict:
    """Scenario IV: six volunteers (3 VM-class + 3 i3-class), two apps."""
    speeds = {"X": VM_SPEED, "Y": VM_SPEED, "Z": VM_SPEED,
              "X'": I3_SPEED, "Y'": I3_SPEED, "Z'": I3_SPEED}
    out = run_scenario({"app1": ("X", APP1), "app2": ("Z", APP2)},
                       speeds, self_leech=True)
    seq_app1_vm, seq_app2_vm = 3.15, 6.73
    res = {
        "app1_h": out.makespan_h["app1"],
        "app2_h": out.makespan_h["app2"],
        "speedup_app1": seq_app1_vm / out.makespan_h["app1"],
        "speedup_app2": seq_app2_vm / out.makespan_h["app2"],
        "paper_speedup_app1": 3.5,
        "paper_speedup_app2": 3.3,
        "cycles": dict(out.cycles),
        "paper_app1_h": 0.89, "paper_app2_h": 1.94,
    }
    res["scenario_out"] = scenario_out_fields(out)
    if verbose:
        print(f"[table4] app1={res['app1_h']:.2f}h (paper ~0.89) "
              f"app2={res['app2_h']:.2f}h (paper ~1.94) "
              f"speedups={res['speedup_app1']:.2f}/{res['speedup_app2']:.2f} "
              f"(paper 3.5/3.3)")
    return res


def scenario_v(verbose: bool = True, n_volunteers: int = 12,
               image_mb: float = 64.0, n_pieces: int = 16,
               n_parts: int = 48, uplink_mbps: float = 100.0) -> dict:
    """Scenario V (paper §V extension): piece-wise multi-seeder swarm.

    Not in the paper's tables — this is the extension §V names ("broken to
    pieces like regular file sharing in torrent") run through the live
    protocol.  Compares single-seeder (monolithic APP_DATA) against the
    swarm on a large app image with per-node uplink contention, and shows
    the app surviving origin-host death because replica seeders take over
    DIST/VAL.
    """
    image_bytes = int(image_mb * 1e6)
    uplink_Bps = uplink_mbps * 1e6 / 8

    def build(swarm: bool):
        rt = SimRuntime(link=LinkModel(uplink_Bps=uplink_Bps))
        rt.add_node(TrackerServer(config=TrackerConfig(ping_interval_s=2.0)))
        host = Agent("host", config=AgentConfig(work_timeout_s=600.0))
        rt.add_node(host)
        app = make_prime_app("appv", "host", 3, 48_000, n_parts=n_parts,
                             sim_time_per_number=1e-4, swarm=swarm,
                             app_bytes=image_bytes,
                             piece_bytes=image_bytes // n_pieces)
        host.host_app(app)
        leechers = []
        for i in range(n_volunteers):
            a = Agent(f"V{i}", config=AgentConfig(work_timeout_s=600.0))
            rt.add_node(a)
            leechers.append(a)
        def done():
            if app.done:
                return True
            return any(a.apps.get("appv") and a.apps["appv"].done
                       for a in leechers)
        return rt, app, leechers, done

    # (a) single seeder: the origin re-ships the image with every part
    rt, app, _, done = build(swarm=False)
    rt.run(until=4 * H, stop_when=done)
    single = {"makespan_s": rt.now(), "done": done(),
              "origin_up_mb": rt.tx_bytes.get("host", 0) / 1e6}

    # (b) swarm: image moves once as pieces, every leecher re-seeds
    rt, app, _, done = build(swarm=True)
    rt.run(until=4 * H, stop_when=done)
    swarm_res = {"makespan_s": rt.now(), "done": done(),
                 "origin_up_mb": rt.tx_bytes.get("host", 0) / 1e6}

    # (c) churn: origin dies mid-run (plus one leecher), replicas take over
    rt, app, leechers, done = build(swarm=True)
    # wait until at least one replica seeder formed, then kill the origin
    rt.run(until=4 * H, stop_when=lambda: any(
        "appv" in a.images for a in leechers))
    killed_at = rt.now()
    rt.nodes.pop("host", None)
    rt.run(until=killed_at + 6.0)
    rt.nodes.pop(leechers[0].node_id, None)   # node churn on top
    rt.run(until=4 * H, stop_when=done)
    failover = {"makespan_s": rt.now(), "done": done(),
                "origin_died_at_s": killed_at}

    res = {
        "single": single, "swarm": swarm_res, "failover": failover,
        "origin_bytes_reduction": (single["origin_up_mb"]
                                   / max(swarm_res["origin_up_mb"], 1e-9)),
        "makespan_speedup": (single["makespan_s"]
                             / max(swarm_res["makespan_s"], 1e-9)),
        # the core/swarm.py round bound the live swarm should approach
        "bound_naive_rounds": n_volunteers * n_pieces,
        "bound_swarm_rounds": n_pieces + max(1, n_volunteers).bit_length(),
    }
    if verbose:
        dnf = "" if single["done"] else " (single DNF at cap — ratios are"
        dnf += "" if single["done"] else " lower bounds)"
        print(f"[scenarioV] single: makespan={single['makespan_s']:.0f}s "
              f"origin_up={single['origin_up_mb']:.0f}MB | swarm: "
              f"makespan={swarm_res['makespan_s']:.0f}s "
              f"origin_up={swarm_res['origin_up_mb']:.0f}MB | "
              f"origin bytes /{res['origin_bytes_reduction']:.0f}, "
              f"makespan x{res['makespan_speedup']:.0f} | failover "
              f"done={failover['done']} t={failover['makespan_s']:.0f}s"
              f"{dnf}")
    return res


def _duplicate_execs(agents, app_id: str, m_min: int) -> int:
    """Completed part executions beyond the m_min the quorum needs,
    summed over parts (the waste endgame PART_CANCEL exists to cap)."""
    import collections as _c
    per_part = _c.Counter(part_id for a in agents
                          for (_, aid, part_id) in a.results_log
                          if aid == app_id)
    return sum(max(0, n - m_min) for n in per_part.values())


def scenario_vi(verbose: bool = True, n_volunteers: int = 24,
                image_mb: float = 32.0, n_pieces: int = 16,
                n_parts: int = 96, m_min: int = 2,
                uplink_mbps: float = 100.0) -> dict:
    """Scenario VI: the PieceExchange engine's choke scheduler + endgame.

    Three swarm variants at N=24 with symmetric uplink/downlink
    contention:

      * baseline — the first swarm engine: no choking, no cancel messages;
        duplicate part executions from seeders' drained partitions run to
        completion and are wasted.
      * unchoked — cancels on (PIECE_CANCEL/PART_CANCEL), choking off:
        shows what endgame reconciliation alone buys.
      * choked   — full engine: fixed upload slots + optimistic unchoke
        on top of endgame cancels.

    Reports origin egress, makespan and duplicate-execution counts.
    """
    image_bytes = int(image_mb * 1e6)
    link_Bps = uplink_mbps * 1e6 / 8

    def run(choke: bool, endgame: bool) -> dict:
        rt = SimRuntime(link=LinkModel(uplink_Bps=link_Bps,
                                       downlink_Bps=link_Bps))
        rt.add_node(TrackerServer(config=TrackerConfig(ping_interval_s=2.0)))
        cfg = dict(work_timeout_s=600.0, choke=choke, endgame=endgame,
                   rechoke_interval_s=5.0)
        host = Agent("host", config=AgentConfig(**cfg))
        rt.add_node(host)
        app = make_prime_app("appvi", "host", 3, 48_000, n_parts=n_parts,
                             sim_time_per_number=1e-2, m_min=m_min,
                             swarm=True, app_bytes=image_bytes,
                             piece_bytes=image_bytes // n_pieces)
        host.host_app(app)
        agents = [host]
        for i in range(n_volunteers):
            a = Agent(f"V{i}", config=AgentConfig(**cfg))
            # heterogeneous volunteers (cf. Scenario IV's mixed machine
            # classes): a homogeneous swarm completes duplicate leases in
            # lockstep, which no cancel message can race
            rt.add_node(a, speed=1.0 - 0.4 * i / max(n_volunteers, 1))
            agents.append(a)

        def done():
            return app.done or any(
                a.apps.get("appvi") and a.apps["appvi"].done
                for a in agents[1:])
        rt.run(until=8 * H, stop_when=done)
        return {"done": done(), "makespan_s": rt.now(),
                "origin_up_mb": rt.tx_bytes.get("host", 0) / 1e6,
                "dup_execs": _duplicate_execs(agents, "appvi", m_min),
                "cancelled_parts": sum(a.cancelled_parts for a in agents),
                "piece_cancels": sum(a.px.cancels_sent for a in agents)}

    baseline = run(choke=False, endgame=False)   # no choke, no cancels
    unchoked = run(choke=False, endgame=True)
    choked = run(choke=True, endgame=True)
    res = {
        "baseline": baseline, "unchoked": unchoked, "choked": choked,
        "dup_exec_reduction": (baseline["dup_execs"]
                               - choked["dup_execs"]),
    }
    if verbose:
        for name in ("baseline", "unchoked", "choked"):
            r = res[name]
            print(f"[scenarioVI] {name}: makespan={r['makespan_s']:.0f}s "
                  f"origin_up={r['origin_up_mb']:.0f}MB "
                  f"dup_execs={r['dup_execs']} "
                  f"cancelled={r['cancelled_parts']} "
                  f"piece_cancels={r['piece_cancels']} "
                  f"done={r['done']}")
        print(f"[scenarioVI] endgame cancels cut duplicate executions by "
              f"{res['dup_exec_reduction']} vs the no-cancel baseline")
    return res


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


def scenario_viii(verbose: bool = True, n_volunteers: int = 48,
                  image_mb: float = 32.0, n_pieces: int = 32,
                  n_parts: Optional[int] = None, m_min: int = 1,
                  loss: float = 0.10, jitter_s: float = 0.2,
                  churn: float = 0.30, seed: int = 8,
                  uplink_mbps: float = 100.0, until_h: float = 4.0,
                  batched: bool = False, device="cuda") -> dict:
    """Scenario VIII: chaos — the swarm under the volunteer-computing
    default operating conditions (lossy consumer links + churn).

    The same N=48 flash crowd is run twice from one seed: once fault-free
    and once under a `FaultPlan` with 10% message loss, 2% duplication,
    200ms reorder jitter and 30% volunteer churn (crash + restart as
    fresh incarnations, scheduled inside the fault-free makespan).  The
    chaos run must still fully replicate — every surviving volunteer
    converges to the verified image — and the headline numbers are the
    *overhead* of surviving the faults: makespan and origin-egress ratios
    vs the fault-free baseline.  The chaos invariants (convergence,
    quorum <= m_min+1, availability bookkeeping exact) are asserted, not
    just measured.

    `batched=True` runs both arms on `ChaosScenario`'s batched path (one
    `SwarmHub` per arm on `device`); each arm's report then carries the
    hub's stats (`tick_wall_s`, `kernel_wall_s`, `batch_ops`, ...).
    """
    if n_parts is None:
        n_parts = 2 * n_volunteers
    common = dict(n_volunteers=n_volunteers, n_pieces=n_pieces,
                  n_parts=n_parts, m_min=m_min,
                  image_bytes=int(image_mb * 1e6), real_image=False,
                  uplink_mbps=uplink_mbps, until_s=until_h * H,
                  batched=batched, device=device)
    base = ChaosScenario(seed=seed, loss=0.0, dup=0.0, jitter_s=0.0,
                         churn=0.0, n_partitions=0, **common).run()
    base.check_invariants()
    # churn/partition schedule scaled to the fault-free makespan, so the
    # chaos run fights faults *during* the distribution, not after it
    horizon = max(base.makespan_s, 30.0)
    chaos = ChaosScenario(seed=seed, loss=loss, dup=0.02,
                          jitter_s=jitter_s, churn=churn, n_partitions=1,
                          partition_s=0.15 * horizon, horizon_s=horizon,
                          **common).run()
    chaos.check_invariants()
    b, c = base.report(), chaos.report()
    res = {
        "baseline": b, "chaos": c, "seed": seed,
        "makespan_overhead": c["makespan_s"] / max(b["makespan_s"], 1e-9),
        "egress_overhead": c["origin_up_mb"] / max(b["origin_up_mb"], 1e-9),
        "replicated": c["replicated"],
        "invariants_ok": True,          # check_invariants() raised otherwise
    }
    if batched:
        res["device"] = str(chaos.hub.device)
    if verbose:
        print(f"[scenarioVIII] N={n_volunteers} img={image_mb:.0f}MB "
              f"loss={loss:.0%} churn={churn:.0%} seed={seed}: "
              f"makespan {b['makespan_s']:.0f}s -> {c['makespan_s']:.0f}s "
              f"(x{res['makespan_overhead']:.2f}) origin_up "
              f"{b['origin_up_mb']:.0f} -> {c['origin_up_mb']:.0f}MB "
              f"(x{res['egress_overhead']:.2f}) dropped={c['dropped_msgs']} "
              f"restarts={c['restarts']} replicated={c['replicated']}")
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


def scenario_x(verbose: bool = True, n_volunteers: int = 200,
               image_mb: float = 64.0, n_pieces: int = 128,
               delta_frac: float = 0.05, uplink_mbps: float = 100.0,
               until_h: float = 8.0, tick_s: float = 0.5, seed: int = 10,
               batched: bool = True, device="cuda",
               include_chaos: bool = True, chaos_volunteers: int = 48,
               chaos_churn: float = 0.30, chaos_loss: float = 0.05,
               chaos_image_mb: float = 4.0, chaos_pieces: int = 32) -> dict:
    """Scenario X: versioned-manifest delta distribution (image upgrades).

    A swarm of N volunteers holds revision v1 of a 64 MB image; the host
    publishes v2 with `delta_frac` of the pieces changed (a versioned
    `PieceManifest` chained by `prev_manifest_hash`).  Volunteers carry
    over their unchanged verified pieces (`PieceInventory.seed_from`) and
    fetch only the delta, against a *scratch* baseline that redistributes
    the full image to the same swarm under a fresh app id.  Headline
    metrics: **upgrade_traffic_bytes** (total bytes on the wire, every
    sender counted) and **upgrade_makespan_s** — target >=10x less than
    scratch on both.

    Chaos overlay: a smaller swarm with REAL image bytes (the reuse rule
    re-hashes every carried-over piece) upgrades while `chaos_churn` of
    the volunteers crash around the publish — half resume with stale v1
    memory (the mixed-version announce case), half restart as fresh
    incarnations off the on-disk piece cache.  Asserted, not measured: no
    engine ever accepts a version-mismatched piece (`stale_accepts == 0`)
    and every survivor converges byte-identical to v2.
    """
    import random as _random
    import time as _time

    from repro_torch.core.workunit import Application, PieceManifest

    image_bytes = int(image_mb * 1e6)
    piece_bytes = image_bytes // n_pieces
    n_changed = max(1, int(round(delta_frac * n_pieces)))
    app_id = "appx"
    vol_ids = [f"V{i:03d}" for i in range(n_volunteers)]
    link_Bps = uplink_mbps * 1e6 / 8

    hub = SwarmHub(device=device) if batched else None
    rt = SimRuntime(link=LinkModel(uplink_Bps=link_Bps,
                                   downlink_Bps=link_Bps))
    if hub is not None:
        rt.crash_hooks.append(hub.node_gone)
    rt.add_node(TrackerServer(config=TrackerConfig(ping_interval_s=5.0)))
    # upload_slots=8 / rechoke=15s: enough parallel unchoke capacity that
    # the 6-piece delta fetch isn't serialized behind the grant scheduler,
    # and rechoke churn doesn't reshuffle holders mid-delta.  Shared by
    # BOTH the upgrade arm and the scratch baseline so the comparison
    # stays apples-to-apples.
    cfg = dict(work_timeout_s=600.0, status_interval_s=5.0,
               rechoke_interval_s=15.0, replicate_completed=True,
               max_replica_seeders=8, upload_slots=8)
    origin = Agent("origin", config=AgentConfig(**cfg), hub=hub)
    rt.add_node(origin)
    app = Application(app_id, "origin", app_bytes=image_bytes, parts=[],
                      swarm=True, piece_bytes=piece_bytes)
    origin.host_app(app)
    agents = []
    for nid in vol_ids:
        a = Agent(nid, config=AgentConfig(**cfg), hub=hub)
        rt.add_node(a)
        agents.append(a)

    def _run(stop) -> None:
        if hub is not None:
            rt.run_batched(until=until_h * H, stop_when=stop,
                           tick_s=tick_s, on_tick=hub.tick)
        else:
            rt.run(until=until_h * H, stop_when=stop)

    def _tx() -> float:
        return float(sum(rt.tx_bytes.values()))

    t0 = _time.perf_counter()
    # phase 1 — v1 flash crowd: the pre-existing swarm state every
    # upgrade starts from
    m1 = app.ensure_manifest()
    not_done = list(agents)

    def v1_done():
        not_done[:] = [a for a in not_done if app_id not in a.images]
        return not not_done

    _run(v1_done)
    v1_makespan = rt.now()
    v1_traffic = _tx()

    # phase 2 — the host publishes v2: delta_frac of the pieces changed,
    # manifest chained to v1; volunteers reuse the rest
    rng = _random.Random(seed)
    changed = set(rng.sample(range(n_pieces), n_changed))
    m2 = PieceManifest.synthetic(app_id, image_bytes, piece_bytes,
                                 version=2, prev=m1, changed=changed)
    t_pub, b_pub = rt.now(), _tx()
    assert origin.publish_update(app_id, m2), "v2 must supersede v1"
    not_up = list(agents)

    def upgraded():
        not_up[:] = [a for a in not_up
                     if a.images.get(app_id) != m2.manifest_hash]
        return not not_up

    _run(upgraded)
    upgrade_makespan = rt.now() - t_pub
    upgrade_traffic = _tx() - b_pub
    engines = [a.px for a in agents] + [origin.px]
    reused = sum(px.reused_pieces for px in engines)
    stale_accepts = sum(px.stale_accepts for px in engines)
    on_v2 = sum(1 for a in agents
                if a.images.get(app_id) == m2.manifest_hash)

    # phase 3 — scratch baseline: the same swarm pulls the same 64 MB as
    # a brand-new app (what redistribution without versioned manifests
    # costs)
    scratch_id = "appx-scratch"
    scratch = Application(scratch_id, "origin", app_bytes=image_bytes,
                          parts=[], swarm=True, piece_bytes=piece_bytes)
    t_s, b_s = rt.now(), _tx()
    origin.host_app(scratch)
    not_s = list(agents)

    def scratch_done():
        not_s[:] = [a for a in not_s if scratch_id not in a.images]
        return not not_s

    _run(scratch_done)
    scratch_makespan = rt.now() - t_s
    scratch_traffic = _tx() - b_s
    wall_s = max(_time.perf_counter() - t0, 1e-9)

    res = {
        "n_volunteers": n_volunteers,
        "image_mb": image_mb,
        "n_pieces": n_pieces,
        "n_changed": n_changed,
        "delta_frac": delta_frac,
        "seed": seed,
        "batched": batched,
        "v1_makespan_s": v1_makespan,
        "v1_traffic_bytes": v1_traffic,
        "upgrade_makespan_s": upgrade_makespan,
        "upgrade_traffic_bytes": upgrade_traffic,
        "scratch_makespan_s": scratch_makespan,
        "scratch_traffic_bytes": scratch_traffic,
        "traffic_reduction": scratch_traffic / max(upgrade_traffic, 1.0),
        "makespan_speedup": scratch_makespan / max(upgrade_makespan, 1e-9),
        "reused_pieces": reused,
        "upgraded": on_v2 == n_volunteers,
        "replicated": (on_v2 == n_volunteers
                       and len(not_done) == 0 and len(not_s) == 0),
        "no_stale": stale_accepts == 0,
        "stale_accepts": stale_accepts,
        "wall_s": wall_s,
    }
    if hub is not None:
        res["device"] = str(hub.device)
        res.update(hub.stats())
    if include_chaos:
        res["chaos"] = _scenario_x_chaos(
            n_volunteers=chaos_volunteers, image_mb=chaos_image_mb,
            n_pieces=chaos_pieces, delta_frac=delta_frac,
            churn=chaos_churn, loss=chaos_loss, seed=seed,
            uplink_mbps=uplink_mbps, until_h=until_h)
        res["chaos_ready"] = res["chaos"]["converged"]
        res["no_stale"] = res["no_stale"] and res["chaos"]["no_stale"]
    if verbose:
        print(f"[scenarioX] N={n_volunteers} img={image_mb:.0f}MB "
              f"delta={n_changed}/{n_pieces} pieces: upgrade "
              f"{upgrade_traffic / 1e6:.0f}MB/{upgrade_makespan:.0f}s vs "
              f"scratch {scratch_traffic / 1e6:.0f}MB/"
              f"{scratch_makespan:.0f}s "
              f"(/{res['traffic_reduction']:.1f} traffic, "
              f"x{res['makespan_speedup']:.1f} makespan) "
              f"reused={reused} stale_accepts={stale_accepts}")
        if include_chaos:
            c = res["chaos"]
            print(f"[scenarioX] chaos churn={chaos_churn:.0%}: "
                  f"converged={c['converged']} reused={c['reused_pieces']} "
                  f"demoted={c['stale_have_demoted']} "
                  f"stale_data={c['stale_piece_data']} "
                  f"refused={c['stale_reqs_refused']} "
                  f"stale_accepts={c['stale_accepts']}")
    return res


def _scenario_x_chaos(n_volunteers: int = 48, image_mb: float = 4.0,
                      n_pieces: int = 32, delta_frac: float = 0.05,
                      churn: float = 0.30, loss: float = 0.05,
                      seed: int = 10, uplink_mbps: float = 100.0,
                      until_h: float = 8.0) -> dict:
    """Scenario X chaos overlay: upgrade during churn, REAL image bytes.

    Run scalar (per-message) so every version gate fires on the wire
    path.  Crash `churn` of the volunteers around the publish: half
    resume with their v1 state intact (they re-announce stale v1 masks
    the upgraded swarm must demote), half restart as fresh incarnations
    whose only v1 remnant is the on-disk piece cache (reused only after
    the content re-hash).  Asserts convergence to byte-identical v2 and
    the mixed-version tripwire `stale_accepts == 0`.
    """
    import random as _random
    import shutil
    import tempfile

    from repro_torch.core.faults import FaultPlan, LinkFault
    from repro_torch.core.workunit import Application, PieceManifest

    image_bytes = int(image_mb * 1e6)
    piece_bytes = image_bytes // n_pieces
    n_changed = max(1, int(round(delta_frac * n_pieces)))
    app_id = "appx-chaos"
    vol_ids = [f"C{i:02d}" for i in range(n_volunteers)]
    link_Bps = uplink_mbps * 1e6 / 8
    rng = _random.Random(seed + 1)
    root = tempfile.mkdtemp(prefix="scenario_x_chaos_")
    try:
        rt = SimRuntime(
            link=LinkModel(uplink_Bps=link_Bps, downlink_Bps=link_Bps),
            faults=FaultPlan(seed=seed + 1,
                             link=LinkFault(drop_p=loss, dup_p=0.02,
                                            jitter_s=0.2)))
        rt.add_node(TrackerServer(config=TrackerConfig(ping_interval_s=2.0)))
        cfg = dict(work_timeout_s=10.0, status_interval_s=1.0,
                   rechoke_interval_s=5.0, piece_timeout_s=5.0,
                   reregister_s=15.0, gossip_interval_s=5.0,
                   replicate_completed=True, root_dir=root)
        engines = []

        def mk(nid: str) -> Agent:
            a = Agent(nid, config=AgentConfig(**cfg))
            engines.append(a.px)
            return a

        origin = mk("origin")
        rt.add_node(origin)
        image1 = bytes((i * 89 + 17) % 256 for i in range(image_bytes))
        app = Application(app_id, "origin", app_bytes=image_bytes,
                          parts=[], swarm=True, piece_bytes=piece_bytes,
                          image=image1)
        origin.host_app(app)
        agents = {}
        for nid in vol_ids:
            agents[nid] = mk(nid)
            rt.add_node(agents[nid])
        m1 = app.ensure_manifest()

        not_done = list(vol_ids)

        def v1_done():
            not_done[:] = [n for n in not_done
                           if app_id not in rt.nodes[n].images]
            return not not_done

        rt.run(until=until_h * H, stop_when=v1_done)
        assert not not_done, "chaos overlay: v1 never fully replicated"

        # v2 image: flip one byte in each changed piece
        changed = set(rng.sample(range(n_pieces), n_changed))
        image2 = bytearray(image1)
        for pid in changed:
            image2[pid * piece_bytes] ^= 0xFF
        image2 = bytes(image2)
        m2 = PieceManifest.from_bytes(app_id, image2, piece_bytes,
                                      version=2, prev=m1)
        assert m2.delta(m1) == changed, "delta must match the edit set"

        # churn around the publish: crash before it (so the victims miss
        # the MANIFEST_UPDATE), restart shortly after.  Suspend/resume
        # victims come back holding complete v1 state in memory — the
        # stale-mask announce case; fresh-incarnation victims come back
        # empty except the on-disk v1 piece cache.
        t_pub = rt.now() + 5.0
        victims = rng.sample(vol_ids, int(round(churn * n_volunteers)))
        for k, nid in enumerate(victims):
            if k % 2 == 0:
                rt.restart_factory[nid] = lambda n=nid: mk(n)
            else:
                rt.restart_factory.pop(nid, None)   # suspend/resume
            rt._at(rng.uniform(rt.now(), t_pub), rt.crash, (nid,))
            rt._at(t_pub + rng.uniform(1.0, 10.0), rt.restart, (nid,))
        rt.run(until=t_pub, stop_when=lambda: False)
        assert origin.publish_update(app_id, m2, image=image2)

        def converged():
            for nid in vol_ids:
                node = rt.nodes.get(nid)
                if node is None or \
                        node.images.get(app_id) != m2.manifest_hash:
                    return False
            return True

        rt.run(until=until_h * H, stop_when=converged)
        ok = converged()
        byte_identical = ok and all(
            rt.nodes[nid].px.assembled_image(app_id) == image2
            for nid in vol_ids)
        stale_accepts = sum(px.stale_accepts for px in engines)
        assert stale_accepts == 0, \
            "mixed-version tripwire fired: a stale piece was accepted"
        assert byte_identical, \
            "chaos overlay: a survivor did not converge to v2 bytes"
        return {
            "n_volunteers": n_volunteers,
            "image_mb": image_mb,
            "churn": churn,
            "loss": loss,
            "converged": ok,
            "byte_identical": byte_identical,
            "no_stale": stale_accepts == 0,
            "stale_accepts": stale_accepts,
            "reused_pieces": sum(px.reused_pieces for px in engines),
            "stale_have_demoted": sum(px.stale_have_demoted
                                      for px in engines),
            "stale_piece_data": sum(px.stale_piece_data
                                    for px in engines),
            "stale_reqs_refused": sum(px.stale_reqs_refused
                                      for px in engines),
            "upgrades": sum(px.upgrades for px in engines),
            "crashes": rt.crash_count,
            "restarts": rt.restart_count,
            "makespan_s": rt.now(),
        }
    finally:
        shutil.rmtree(root, ignore_errors=True)


def scenario_xi(verbose: bool = True, n_replicas: int = 50,
                ckpt_mb: float = 2048.0, n_pieces: int = 128,
                n_islands: int = 8, uplink_mbps: float = 200.0,
                until_h: float = 48.0, seed: int = 11,
                include_chaos: bool = True,
                include_islands: bool = True) -> dict:
    """Scenario XI: swarm-served checkpoints — replica cold-start flash
    crowd pulling a multi-GB sharded checkpoint.

    The production story behind the ROADMAP's "close the loop with the
    jax side": an autoscaling event brings up R fresh serving replicas at
    t=0 and all of them need the same committed checkpoint.  The
    checkpoint is a pure-replication swarm Application (no work parts —
    `checkpoint/swarm_restore.checkpoint_application` builds the same
    shape from a real `CheckpointStore` step; here the multi-GB image is
    simulated bytes on the same protocol).  Two modes per topology:

      * ``origin`` — the blob-store baseline: every replica pulls every
        piece straight from the origin (`AgentConfig.fetch_from`), which
        serialises R full images through one uplink;
      * ``swarm``  — replicas exchange pieces leecher-to-seeder, so the
        origin uploads each piece roughly once.

    Run on a flat LAN and on an `n_islands` WAN (tracker serves the ALTO
    COST_MAP, scalar P4P selection).  Headline metrics per run:
    **ttr_p99_s** (p99 time-to-ready across replicas — a replica is
    ready the moment its verified piece set completes and it can load
    params) and **origin_egress_bytes**.  Targets: >=10x origin egress
    cut, >=3x p99 time-to-ready.  Chaos overlay: the origin dies as soon
    as the first replica is ready and every replica must still become
    ready from replica seeders alone.
    """
    from repro_torch.core.workunit import Application

    ckpt_bytes = int(ckpt_mb * 1e6)
    link_Bps = uplink_mbps * 1e6 / 8
    app_id = "ckpt"
    rep_ids = [f"R{i:03d}" for i in range(n_replicas)]

    def _one(origin_only: bool, islands: int, chaos: bool = False) -> dict:
        topo = Topology.make(["origin"] + rep_ids, islands, seed=seed) \
            if islands else None
        rt = SimRuntime(link=LinkModel(uplink_Bps=link_Bps,
                                       downlink_Bps=link_Bps),
                        topology=topo)
        rt.add_node(TrackerServer(config=TrackerConfig(ping_interval_s=5.0),
                                  topology=topo))
        cfg = dict(work_timeout_s=600.0, status_interval_s=5.0,
                   rechoke_interval_s=5.0, replicate_completed=True,
                   max_replica_seeders=8)
        origin = Agent("origin", config=AgentConfig(**cfg))
        rt.add_node(origin)
        # the checkpoint as a pure-replication Application: real deploys
        # host checkpoint_application(store); the benchmark's multi-GB
        # image stays synthetic so only metadata ever materialises
        app = Application(app_id, "origin", app_bytes=ckpt_bytes,
                          parts=[], swarm=True,
                          piece_bytes=ckpt_bytes // n_pieces)
        origin.host_app(app)
        rcfg = dict(cfg, fetch_from=("origin",)) if origin_only else cfg
        replicas = []
        for nid in rep_ids:
            a = Agent(nid, config=AgentConfig(**rcfg))
            rt.add_node(a)
            replicas.append(a)

        died_at = None
        if chaos:
            # flash crowd starts; the origin dies the moment the first
            # replica turns seeder (scenario V's failover pattern)
            rt.run(until=until_h * H,
                   stop_when=lambda: any(app_id in a.images
                                         for a in replicas))
            died_at = rt.now()
            rt.nodes.pop("origin", None)
        not_ready = list(replicas)

        def all_ready():
            not_ready[:] = [a for a in not_ready
                            if app_id not in a.images]
            return not not_ready

        rt.run(until=until_h * H, stop_when=all_ready)
        times = sorted(a.image_completed_at.get(app_id, rt.now())
                       for a in replicas)
        p99 = times[min(int(0.99 * (len(times) - 1)), len(times) - 1)]
        n_ready = sum(1 for a in replicas if app_id in a.images)
        out = {
            "mode": "chaos" if chaos
            else ("origin" if origin_only else "swarm"),
            "islands": islands,
            "ready": n_ready == n_replicas,
            "replicas_ready": n_ready,
            "ttr_p99_s": p99,
            "ttr_max_s": times[-1] if times else 0.0,
            "ttr_median_s": times[len(times) // 2] if times else 0.0,
            "origin_egress_bytes": float(rt.tx_bytes.get("origin", 0)),
            "cross_isp_bytes": rt.cross_isp_bytes,
            "events": rt.events_processed,
        }
        if died_at is not None:
            out["origin_died_at_s"] = died_at
        return out

    flat_origin = _one(origin_only=True, islands=0)
    flat_swarm = _one(origin_only=False, islands=0)
    res = {
        "n_replicas": n_replicas,
        "ckpt_mb": ckpt_mb,
        "n_pieces": n_pieces,
        "n_islands": n_islands,
        "seed": seed,
        "flat": {"origin": flat_origin, "swarm": flat_swarm},
        "egress_reduction_flat": flat_origin["origin_egress_bytes"]
        / max(flat_swarm["origin_egress_bytes"], 1.0),
        "ttr_p99_speedup_flat": flat_origin["ttr_p99_s"]
        / max(flat_swarm["ttr_p99_s"], 1e-9),
    }
    all_ready = flat_origin["ready"] and flat_swarm["ready"]
    if include_islands:
        isl_origin = _one(origin_only=True, islands=n_islands)
        isl_swarm = _one(origin_only=False, islands=n_islands)
        res["islands"] = {"origin": isl_origin, "swarm": isl_swarm}
        res["egress_reduction_islands"] = \
            isl_origin["origin_egress_bytes"] \
            / max(isl_swarm["origin_egress_bytes"], 1.0)
        res["ttr_p99_speedup_islands"] = isl_origin["ttr_p99_s"] \
            / max(isl_swarm["ttr_p99_s"], 1e-9)
        all_ready = all_ready and isl_origin["ready"] and isl_swarm["ready"]
    if include_chaos:
        chaos = _one(origin_only=False, islands=0, chaos=True)
        res["chaos"] = chaos
        all_ready = all_ready and chaos["ready"]
    res["all_ready"] = all_ready
    if verbose:
        o, s = flat_origin, flat_swarm
        print(f"[scenarioXI] R={n_replicas} ckpt={ckpt_mb:.0f}MB flat: "
              f"ttr_p99 {o['ttr_p99_s']:.0f} -> {s['ttr_p99_s']:.0f}s "
              f"(x{res['ttr_p99_speedup_flat']:.1f}) origin_egress "
              f"{o['origin_egress_bytes'] / 1e9:.1f} -> "
              f"{s['origin_egress_bytes'] / 1e9:.1f}GB "
              f"(/{res['egress_reduction_flat']:.1f})")
        if include_islands:
            o, s = res["islands"]["origin"], res["islands"]["swarm"]
            print(f"[scenarioXI] {n_islands} islands: ttr_p99 "
                  f"{o['ttr_p99_s']:.0f} -> {s['ttr_p99_s']:.0f}s "
                  f"(x{res['ttr_p99_speedup_islands']:.1f}) origin_egress "
                  f"{o['origin_egress_bytes'] / 1e9:.1f} -> "
                  f"{s['origin_egress_bytes'] / 1e9:.1f}GB "
                  f"(/{res['egress_reduction_islands']:.1f})")
        if include_chaos:
            c = res["chaos"]
            print(f"[scenarioXI] chaos: origin died at "
                  f"{c['origin_died_at_s']:.0f}s, "
                  f"{c['replicas_ready']}/{n_replicas} replicas ready "
                  f"(all_ready={c['ready']}) ttr_p99={c['ttr_p99_s']:.0f}s")
    return res


ALL_TABLES = {"table1": table1, "table2": table2, "table3": table3,
              "table4": table4, "scenario_v": scenario_v,
              "scenario_vi": scenario_vi, "scenario_vii": scenario_vii,
              "scenario_viii": scenario_viii, "scenario_ix": scenario_ix,
              "scenario_x": scenario_x, "scenario_xi": scenario_xi}


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.scenarios",
        description="Run the paper's tables and the swarm scenarios and "
                    "print their lines.")
    ap.add_argument("names", nargs="*", metavar="name",
                    help=f"of {', '.join(ALL_TABLES)} (default: all, in "
                         f"that order)")
    ap.add_argument("--device", default="cuda",
                    help="device of the batched hub (scenarios VII-X)")
    args = ap.parse_args(argv)
    unknown = [n for n in args.names if n not in ALL_TABLES]
    if unknown:
        ap.error(f"unknown names {unknown}")
    for name in args.names or ALL_TABLES:
        fn = ALL_TABLES[name]
        if name in SCALAR:
            fn()
        else:
            fn(device=args.device)


if __name__ == "__main__":
    main()
