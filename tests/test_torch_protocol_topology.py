"""Topology layer (core/topology + runtime WAN leg + P4P selection):
flat-topology trace identity (run and run_batched), `_topo_delay` send
semantics (cross-ISP accounting, WAN latency, trunk serialisation),
cost-kernel differentials (uniform plane == rarest-first, cost dominance,
island availability vs naive loops), scalar and batched peer-selection
preference with shun-dominates-cost decay, tracker COST_MAP delivery,
and the island-aligned chaos overlay.

The reference's `tests/test_topology.py`, run on `repro_torch.core` on
the CPU.  Where the reference hands numpy arrays to its kernels, these
cases hand the same arrays to the port's as tensors; where it compares
its jax backends with numpy, the port's plain versions are held against
the reference's numpy ones; the batched hub, the chaos run and Scenario
IX run with ``device="cpu"``.  `test_bench_guard_flags_cross_isp_and_p99_
regressions` is not repeated here: it tests `benchmarks/bench_guard.py`,
which no part of the port runs."""
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.protocol

from repro_torch.core import (Agent, AgentConfig, LinkModel, Msg,  # noqa: E402
                              PieceManifest, SimRuntime, SwarmHub, Topology,
                              TrackerConfig, TrackerServer, make_prime_app)
from repro_torch.core import swarm_kernels as sk  # noqa: E402
from repro_torch.core.messages import HAVE, PIECE_REQ, UNCHOKE  # noqa: E402
from repro_torch.core.runtime import Node  # noqa: E402
from test_torch_protocol_exchange_scaling import _engine  # noqa: E402


def t(a):
    return torch.from_numpy(a)


# ==================== flat-topology trace identity ====================== #
def _mini_flash(n_leechers=4, topology=None):
    rt = SimRuntime(link=LinkModel(uplink_Bps=12.5e6, downlink_Bps=12.5e6),
                    topology=topology)
    rt.add_node(TrackerServer(config=TrackerConfig(ping_interval_s=2.0)))
    host = Agent("host", config=AgentConfig(work_timeout_s=600.0))
    rt.add_node(host)
    app = make_prime_app("mm-app", "host", 3, 6_000, n_parts=6,
                         sim_time_per_number=1e-4, swarm=True,
                         app_bytes=262_144, piece_bytes=32_768)
    host.host_app(app)
    leech = [Agent(f"L{i}", config=AgentConfig(work_timeout_s=600.0))
             for i in range(n_leechers)]
    for a in leech:
        rt.add_node(a)
    done = lambda: all("mm-app" in a.images for a in leech)
    return rt, host, leech, done


def _trace(rt, host):
    return (rt.events_processed, repr(rt._seq), rt.now(),
            dict(rt.tx_bytes), rt.cross_isp_bytes, host.completed_at)


def test_flat_topology_is_event_identical_to_none():
    """`topology=None`, `Topology.flat(...)` and a hand-built one-island
    zero-latency topology must drain the same scenario pop-for-pop: same
    event count, same push watermark, same clock, same per-node bytes —
    and the flat runs never count a cross-ISP byte.  This is the
    transport-layer invariant (the tracker is deliberately given no
    topology here: COST_MAP is a protocol change, not a transport one)."""
    ids = ["server", "host"] + [f"L{i}" for i in range(4)]
    topos = [None, Topology.flat(ids),
             Topology({n: 0 for n in ids}, 1, [[0.0]])]
    traces = []
    for topo in topos:
        rt, host, _, done = _mini_flash(topology=topo)
        rt.run(until=3_600, stop_when=done)
        assert done()
        traces.append(_trace(rt, host))
    assert traces[0] == traces[1] == traces[2]
    assert traces[0][4] == 0                       # cross_isp_bytes


def test_flat_topology_run_batched_identical_to_none():
    """Same invariant on the batched driver: the tick loop shares the
    heap with `run`, so a flat topology must be equally inert there."""
    a_rt, a_host, _, a_done = _mini_flash()
    b_rt, b_host, _, b_done = _mini_flash(
        topology=Topology.flat(["server", "host"]
                               + [f"L{i}" for i in range(4)]))
    a_rt.run_batched(until=3_600, stop_when=a_done, tick_s=0.25)
    b_rt.run_batched(until=3_600, stop_when=b_done, tick_s=0.25)
    assert a_done() and b_done()
    assert _trace(a_rt, a_host) == _trace(b_rt, b_host)


# ======================= _topo_delay send semantics ===================== #
class _Sink(Node):
    def __init__(self, node_id):
        self.node_id = node_id
        self.got = []                              # (virtual_t, msg)

    def on_message(self, msg):
        self.got.append((self.rt.now(), msg))


def _wan_pair(topology, link=None):
    rt = SimRuntime(link=link or LinkModel(), topology=topology)
    sinks = {n: _Sink(n) for n in ("a", "b", "c")}
    for s in sinks.values():
        rt.add_node(s)
    return rt, sinks


def test_cross_island_send_adds_latency_and_counts_bytes():
    topo = Topology({"a": 0, "b": 1, "c": 0}, 2,
                    [[0.0, 0.05], [0.05, 0.0]])
    rt, sinks = _wan_pair(topo)
    flat, fsinks = _wan_pair(None)
    for r in (rt, flat):
        r.send("b", Msg("X", "a", {}, size_bytes=1000))   # cross
        r.send("c", Msg("X", "a", {}, size_bytes=500))    # intra
        r.run(until=10.0)
    t_cross, t_intra = sinks["b"].got[0][0], sinks["c"].got[0][0]
    f_cross, f_intra = fsinks["b"].got[0][0], fsinks["c"].got[0][0]
    assert t_cross == pytest.approx(f_cross + 0.05)   # one-way WAN leg
    assert t_intra == f_intra                         # intra untouched
    assert rt.cross_isp_bytes == 1000                 # intra not counted
    assert flat.cross_isp_bytes == 0


def test_cross_island_bulk_serialises_through_trunk():
    """Two bulk transfers from different island-0 sources into island 1
    queue behind each other on the shared (0, 1) trunk pipe, while the
    same sends with no trunk matrix land at independent times."""
    size = 1 << 17                                 # > bulk threshold
    lat = [[0.0, 0.01], [0.01, 0.0]]
    islands = {"a": 0, "c": 0, "b": 1}
    trunk = 1e6
    topo = Topology(islands, 2, lat,
                    bandwidth_Bps=[[None, trunk], [trunk, None]])
    free = Topology(islands, 2, lat)
    t_times, f_times = [], []
    for topology, times in ((topo, t_times), (free, f_times)):
        rt, sinks = _wan_pair(topology)
        rt.send("b", Msg("X", "a", {}, size_bytes=size))
        rt.send("b", Msg("X", "c", {}, size_bytes=size))
        rt.run(until=60.0)
        times.extend(t for t, _ in sinks["b"].got)
    assert len(t_times) == len(f_times) == 2
    # no trunk: both cross sends see only the WAN latency -> same arrival
    assert f_times[0] == f_times[1]
    # trunk: the second transfer starts where the first left the pipe
    assert t_times[1] - t_times[0] == pytest.approx(size / trunk)


# ========================= cost kernels ================================= #
def test_island_has_and_min_cost_match_naive_loops():
    rng = random.Random(13)
    for _ in range(30):
        n, p, k = (rng.randrange(1, 40), rng.randrange(1, 60),
                   rng.randrange(1, 8))
        have = np.array([[rng.random() < 0.3 for _ in range(p)]
                         for _ in range(n)], dtype=bool)
        island = np.array([rng.randrange(k) for _ in range(n)])
        member = np.zeros((k, n), dtype=bool)
        member[island, np.arange(n)] = True
        avail = sk.island_has(t(have), t(member)).numpy()
        cost = np.array([[0 if i == j else rng.randrange(1, 16)
                          for j in range(k)] for i in range(k)],
                        dtype=np.int64)
        plane = sk.min_island_cost(t(avail), t(cost)).numpy()
        assert avail.shape == (k, p) and plane.shape == (k, p)
        for ki in range(k):
            for pi in range(p):
                holders = [i for i in range(n) if have[i, pi]]
                want = any(island[i] == ki for i in holders)
                assert avail[ki, pi] == want
                costs = [cost[ki, island[i]] for i in holders]
                assert plane[ki, pi] == (min(costs) if costs
                                         else sk.COST_NONE)


def test_cost_orders_uniform_plane_equals_rarest_orders():
    """A uniform cost plane shifts every composite key by the same
    amount: the P4P order must be bit-identical to plain rarest-first —
    the decay-to-rarity property the chaos overlay relies on."""
    rng = random.Random(29)
    for _ in range(20):
        n_pieces, n_rows = rng.randrange(1, 80), rng.randrange(1, 10)
        counts = np.array([rng.randrange(0, 7) for _ in range(n_pieces)],
                          dtype=np.int32)
        missing = np.array([[rng.random() < 0.5 for _ in range(n_pieces)]
                            for _ in range(n_rows)], dtype=bool)
        offsets = np.array([rng.randrange(0, 500) for _ in range(n_rows)],
                           dtype=np.int64)
        level = rng.randrange(0, 16)
        plane = np.full((n_rows, n_pieces), level, dtype=np.int64)
        got = sk.cost_orders(t(missing), t(counts), t(offsets), t(plane),
                             n_pieces)
        want = sk.rarest_orders(t(missing), t(counts), t(offsets), n_pieces)
        assert got.tolist() == want.tolist()


def test_cost_orders_cost_dominates_rarity():
    """A piece held on a cheap island outranks a strictly rarer piece
    only reachable across an expensive trunk; within one cost level the
    rarest-first order is preserved."""
    counts = np.array([1, 5, 3, 5], dtype=np.int32)   # 0 is the rarest
    missing = np.ones((1, 4), dtype=bool)
    offsets = np.zeros(1, dtype=np.int64)
    plane = np.array([[9, 0, 0, 0]], dtype=np.int64)  # rare but far
    order = sk.cost_orders(t(missing), t(counts), t(offsets), t(plane), 4)
    assert order[0].tolist() == [2, 1, 3, 0]          # cost, then rarity


def test_cost_kernels_agree_with_the_references_numpy():
    """The port's plain `island_has` and `cost_orders` against the
    reference's numpy backend (the reference case holds its jax
    backends to it)."""
    from repro.core import swarm_kernels as ref
    rng = random.Random(41)
    for _ in range(8):
        n, p, k = (rng.randrange(1, 60), rng.randrange(1, 200),
                   rng.randrange(1, 9))
        have = np.array([[rng.random() < 0.4 for _ in range(p)]
                         for _ in range(n)], dtype=bool)
        island = np.array([rng.randrange(k) for _ in range(n)])
        member = np.zeros((k, n), dtype=bool)
        member[island, np.arange(n)] = True
        want = ref.island_has_np(have, member)
        counts = np.array([rng.randrange(0, 9) for _ in range(p)],
                          dtype=np.int32)
        missing = np.array([[rng.random() < 0.5 for _ in range(p)]
                            for _ in range(3)], dtype=bool)
        offsets = np.array([rng.randrange(0, 999) for _ in range(3)],
                           dtype=np.int64)
        plane = np.array([[rng.randrange(0, 16) for _ in range(p)]
                          for _ in range(3)], dtype=np.int64)
        oref = ref.cost_orders(missing, counts, offsets, plane, p,
                               backend="numpy")
        assert sk.island_has(t(have), t(member)).tolist() == want.tolist()
        assert sk.cost_orders(t(missing), t(counts), t(offsets), t(plane),
                              p).tolist() == oref.tolist()


# =================== scalar P4P selection preference ==================== #
def _loaded_engine(n_pieces=1, holders=("A", "B", "C")):
    px, log = _engine()
    manifest = PieceManifest.synthetic("a", n_pieces * 1000, 1000)
    px.join("a", manifest)
    orig_pump, px.pump = px.pump, lambda app_id: None
    full = (1 << n_pieces) - 1
    for h in holders:
        px.on_have(Msg(HAVE, h, {"app_id": "a", "mask": full}))
        px.on_unchoke(Msg(UNCHOKE, h, {"app_id": "a"}))
    px.pump = orig_pump
    return px, log


def _reqs(log, n0=0):
    return [(dst, m.payload["piece_id"], bool(m.payload.get("endgame")))
            for dst, m in log[n0:] if m.kind == PIECE_REQ]


def test_scalar_pump_prefers_cheapest_island_holder():
    px, log = _loaded_engine()
    # L sits on island 0 with A; B and C are 5 and 2 away
    px.set_cost_map(0, [0, 5, 2], {"A": 0, "B": 1, "C": 2})
    px.pump("a")
    assert _reqs(log) == [("A", 0, False)]


def test_scalar_pump_shun_dominates_cost():
    """A shunned same-island holder loses to a clean remote one: the P4P
    bias decays to plain availability when the cheap holders starve."""
    px, log = _loaded_engine()
    px.set_cost_map(0, [0, 5, 2], {"A": 0, "B": 1, "C": 2})
    px.stalled_holders["a"] = {0: {"A", "C"}}
    px.pump("a")
    assert _reqs(log) == [("B", 0, False)]


def test_scalar_endgame_duplicates_cheapest_first():
    px, log = _loaded_engine()
    px.set_cost_map(0, [0, 5, 2], {"A": 0, "B": 1, "C": 2})
    px.pump("a")                                   # piece 0 -> A
    n0 = len(log)
    px._endgame("a")                               # duplicate to B and C
    assert _reqs(log, n0) == [("C", 0, True), ("B", 0, True)]


def test_scalar_without_cost_map_is_order_neutral():
    """No COST_MAP received: `_peer_cost` is identically 0 and the pump
    falls back to the historical (load, name) tie-break."""
    px, log = _loaded_engine()
    assert px._peer_cost("A") == px._peer_cost("ZZZ") == 0
    px.pump("a")
    assert _reqs(log) == [("A", 0, False)]         # name order, as before


# =================== batched hub selection preference =================== #
def test_batched_hub_prefers_same_island_holder():
    topo = Topology({"L": 0, "A": 0, "B": 1}, 2, [[0.0, 0.05],
                                                  [0.05, 0.0]])
    flipped = Topology({"L": 1, "A": 0, "B": 1}, 2, [[0.0, 0.05],
                                                     [0.05, 0.0]])
    for topology, want in ((None, "A"), (topo, "A"), (flipped, "B")):
        px, _ = _loaded_engine(n_pieces=4, holders=("A", "B"))
        hub = SwarmHub.mirror_scalar(px, "a", device="cpu")
        if topology is not None:
            hub.set_topology(topology)
        got = hub.decide_requests("a", "L", now=0.0)
        assert got, topology
        assert got[0][1] == want, topology


def test_batched_hub_cost_map_roundtrip():
    """set_topology(None) restores the flat decision set bit-identically
    (the cost matrix and per-row islands are fully cleared)."""
    px, _ = _loaded_engine(n_pieces=6, holders=("A", "B"))
    hub = SwarmHub.mirror_scalar(px, "a", device="cpu")
    flat = hub.decide_requests("a", "L", now=0.0)
    hub.set_topology(Topology({"L": 1, "A": 0, "B": 1}, 2,
                              [[0.0, 0.08], [0.08, 0.0]]))
    hub.set_topology(None)
    assert hub.decide_requests("a", "L", now=0.0) == flat


# ================== tracker COST_MAP + end-to-end ======================= #
def test_tracker_serves_cost_map_on_register():
    ids = ["server", "host"] + [f"L{i}" for i in range(4)]
    topo = Topology.make(ids, 2, seed=7)
    rt = SimRuntime(link=LinkModel(uplink_Bps=12.5e6,
                                   downlink_Bps=12.5e6),
                    topology=topo)
    rt.add_node(TrackerServer(config=TrackerConfig(ping_interval_s=2.0),
                              topology=topo))
    host = Agent("host", config=AgentConfig(work_timeout_s=600.0))
    rt.add_node(host)
    app = make_prime_app("mm-app", "host", 3, 6_000, n_parts=6,
                         sim_time_per_number=1e-4, swarm=True,
                         app_bytes=262_144, piece_bytes=32_768)
    host.host_app(app)
    leech = [Agent(f"L{i}", config=AgentConfig(work_timeout_s=600.0))
             for i in range(4)]
    for a in leech:
        rt.add_node(a)
    done = lambda: all("mm-app" in a.images for a in leech)
    rt.run(until=3_600, stop_when=done)
    assert done()
    assert rt.cross_isp_bytes > 0
    for a in leech:
        isl = topo.island_of(a.node_id)
        assert a.px.my_island == isl
        assert a.px.island_costs == topo.cost_row(isl)
        assert a.px.peer_islands == topo.islands


# =================== island-aligned chaos overlay ======================= #
@pytest.mark.parametrize("batched", [False, True])
def test_chaos_with_islands_still_replicates(batched):
    """Seeded FaultPlan whose partitions cut along island boundaries, on
    top of WAN latency + P4P selection: the swarm must still fully
    replicate (the cost bias decays to rarity when every same-island
    holder is cut or starved) and the run must see cross-ISP traffic."""
    from repro_torch.core.chaos import ChaosScenario
    sc = ChaosScenario(seed=3, n_volunteers=8, n_pieces=12, n_parts=16,
                       image_bytes=96_000, real_image=False,
                       batched=batched, n_islands=3,
                       island_partitions=True, device="cpu").run()
    sc.check_invariants()
    rep = sc.report()
    assert rep["replicated"] and rep["done"]
    assert rep["cross_isp_bytes"] > 0


# ===================== Scenario IX economics smoke ====================== #
def test_scenario_ix_smoke_cuts_cross_isp_traffic():
    """N=64 / 4 islands: P4P selection must cut cross-ISP bytes by a
    wide margin without losing full replication (the CI-guarded
    acceptance numbers come from the benchmark rows; this pins the
    mechanism end-to-end in-process)."""
    from repro_torch.scenarios import scenario_ix
    res = scenario_ix(verbose=False, n_volunteers=64, n_islands=4,
                      image_mb=8.0, device="cpu")
    assert res["naive"]["replicated"] and res["p4p"]["replicated"]
    assert res["cross_isp_reduction"] >= 5.0
    assert res["makespan_ratio"] <= 1.05
