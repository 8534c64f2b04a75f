"""`repro_torch.core.swarm_arrays` (SwarmState with device planes, and the
SwarmHub tick) on the CPU: the ledger-vs-dict trace, the mirror_scalar
request-for-request trace against the scalar engine, single-pass growth
of the host arrays and the device planes, and one pump computed from a
reference hub's mid-run state loaded with `load_state_arrays`."""
import random
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (Agent, AgentConfig, LinkModel,  # noqa: E402
                              Msg, PieceExchange, PieceManifest, SimRuntime,
                              SwarmHub, TrackerConfig, TrackerServer,
                              make_prime_app)
from repro_torch.core.messages import HAVE, PIECE_REQ, UNCHOKE  # noqa: E402
from repro_torch.core.swarm_arrays import (SwarmState,  # noqa: E402
                                           load_state_arrays)


def _engine(node_id="L", hub=None, **over):
    cfg = AgentConfig(**over)
    log = []
    px = PieceExchange(node_id, cfg,
                       send=lambda dst, msg: log.append((dst, msg)),
                       now=lambda: 0.0, tracker_id="server", hub=hub)
    return px, log


def _assert_planes_match_host(hub):
    """After a sync, every device plane equals the host array it mirrors
    on every row: a hook that forgot to mark its row shows up here."""
    for st in hub.states.values():
        st.sync_planes()
        for plane, host in SwarmState._PLANES.items():
            want = getattr(st, host)
            got = getattr(st, plane).cpu().numpy()
            assert np.array_equal(got, want.astype(got.dtype)), plane


# ============== trace differential: hub vs scalar pump ================== #
def test_batched_requests_match_scalar_over_seeded_trace():
    """320-event seeded trace: after every event, a port hub mirroring the
    scalar engine's information set predicts the scalar pump's PIECE_REQ
    decisions request for request, and its endgame bridge the scalar
    endgame duplicates."""
    n_pieces = 64
    manifest = PieceManifest.synthetic("a", n_pieces * 1000, 1000)
    px, log = _engine(piece_pipeline=6)
    rng = random.Random(97)
    peers = [f"P{i}" for i in range(16)]
    px.join("a", manifest)
    px.note_full_seeders("a", set(peers[:2]))
    compared = 0
    for step in range(320):
        orig_pump, px.pump = px.pump, lambda app_id: None
        roll = rng.random()
        if roll < 0.5:
            px.on_have(Msg(HAVE, rng.choice(peers),
                           {"app_id": "a",
                            "mask": rng.getrandbits(n_pieces)}))
        elif roll < 0.8:
            px.on_unchoke(Msg(UNCHOKE, rng.choice(peers), {"app_id": "a"}))
        else:
            px.on_peer_gone(rng.choice(peers))
        px.pump = orig_pump
        hub = SwarmHub.mirror_scalar(px, "a", device="cpu")
        want = hub.decide_requests("a", "L", now=0.0)
        want_eg = hub.decide_endgame("a", "L", now=0.0)
        n0 = len(log)
        px.pump("a")
        got = [(m.payload["piece_id"], d) for d, m in log[n0:]
               if m.kind == PIECE_REQ and not m.payload.get("endgame")]
        got_eg = [(m.payload["piece_id"], d) for d, m in log[n0:]
                  if m.kind == PIECE_REQ and m.payload.get("endgame")]
        assert got == want, f"step {step}"
        assert got_eg == want_eg, f"step {step} (endgame)"
        compared += len(got)
    assert compared > 10


# ========= array ledger vs scalar pending dicts, planes vs host ========= #
def _assert_ledger_matches_dicts(hub):
    entries = 0
    max_dup = 0
    for st in hub.states.values():
        for name, i in st.row.items():
            px = st.clients[i]
            if px is None or not st.alive[i]:
                continue
            pending = px.pending.get(st.app_id, {})
            assert int(st.pend_n[i]) == len(pending), name
            assert int(st.pipeline[i]) == int(px.cfg.piece_pipeline)
            total = 0
            for p, asked in pending.items():
                cnt = int(st.pend_cnt[i, p])
                assert cnt == len(asked), (name, p)
                max_dup = max(max_dup, cnt)
                named = {}
                rowless = []
                for s in range(cnt):
                    j = int(st.pend_holder[i, p, s])
                    t = float(st.pend_t[i, p, s])
                    if j >= 0:
                        named[st.names[j]] = t
                    else:
                        assert j == -2, (name, p, s)
                        rowless.append(t)
                assert named == {h: float(t) for h, t in asked.items()
                                 if h in st.row}, (name, p)
                assert sorted(rowless) == sorted(
                    float(t) for h, t in asked.items()
                    if h not in st.row), (name, p)
                total += cnt
                entries += cnt
            assert int(st.pend_cnt[i].astype(np.int64).sum()) == total, name
    return entries, max_dup


def test_array_ledger_and_planes_track_engines_over_trace():
    """Seeded >=500-event batched flash crowd on the port: after EVERY
    tick the array ledger equals the scalar `px.pending` dicts entry for
    entry, and the device planes equal the host arrays they mirror."""
    rt = SimRuntime(link=LinkModel(uplink_Bps=12.5e6,
                                   downlink_Bps=12.5e6))
    rt.add_node(TrackerServer(config=TrackerConfig(ping_interval_s=2.0)))
    hub = SwarmHub(device="cpu")
    host = Agent("host", config=AgentConfig(work_timeout_s=600.0),
                 hub=hub)
    rt.add_node(host)
    app = make_prime_app("lg-app", "host", 3, 6_000, n_parts=8,
                         sim_time_per_number=1e-4, swarm=True,
                         app_bytes=16 * 32_768, piece_bytes=32_768)
    host.host_app(app)
    leech = [Agent(f"L{i}", config=AgentConfig(work_timeout_s=600.0),
                   hub=hub) for i in range(6)]
    for a in leech:
        rt.add_node(a)
    rt.crash_hooks.append(hub.node_gone)
    done = lambda: all("lg-app" in a.images for a in leech)
    stats = {"checks": 0, "entries": 0, "max_dup": 0}

    def on_tick(now):
        hub.tick(now)
        entries, max_dup = _assert_ledger_matches_dicts(hub)
        _assert_planes_match_host(hub)
        stats["checks"] += 1
        stats["entries"] += entries
        stats["max_dup"] = max(stats["max_dup"], max_dup)

    rt.run_batched(until=3_600, stop_when=done, tick_s=0.5,
                   on_tick=on_tick)
    assert done()
    _assert_ledger_matches_dicts(hub)
    _assert_planes_match_host(hub)
    assert rt.events_processed >= 500
    assert stats["checks"] > 0 and stats["entries"] > 0
    assert hub.ledger_ops > 0
    cancels = sum(a.px.cancels_sent for a in leech + [host])
    assert stats["max_dup"] >= 2 or cancels > 0


def test_planes_follow_crash_and_topology_changes():
    """node_gone and set_topology reach the device planes through the
    dirty-row set."""
    from repro_torch.core import Topology
    hub = SwarmHub(device="cpu")
    m = PieceManifest.synthetic("a", 8_000, 1_000)
    seeder, _ = _engine("S", hub=hub)
    seeder.add_local_app("a", m)
    leech, _ = _engine("L", hub=hub)
    leech.join("a", m)
    hub.note_have(leech, "a", 3)
    _assert_planes_match_host(hub)
    hub.node_gone("S")
    _assert_planes_match_host(hub)
    st = hub.states[("a", 1)]
    assert int(st.alive_d[st.row["S"]]) == 0
    hub.set_topology(Topology.make(["S", "L"], 2, seed=1))
    _assert_planes_match_host(hub)
    assert st.island_d[: st.n].tolist() == st.island[: st.n].tolist()
    hub.set_topology(None)
    _assert_planes_match_host(hub)


# =========== single-pass SwarmState growth, host and device ============= #
def test_swarm_state_growth_single_pass_covers_rows_and_planes():
    m = PieceManifest.synthetic("g", 8_000, 1_000)     # P=8 != cap=4
    st = SwarmState("g", m, capacity=4, device="cpu")
    cap = st.have.shape[0]
    assert cap == 4 and st.P == 8
    per_row = {name for name, a in vars(st).items()
               if isinstance(a, np.ndarray) and a.ndim >= 1
               and a.shape[0] == cap}
    assert per_row == set(SwarmState._ROW_ARRAYS)
    planes = {name for name, a in vars(st).items()
              if isinstance(a, torch.Tensor) and a.shape[0] == cap}
    assert planes == set(SwarmState._PLANES)
    assert set(SwarmState._PLANES.values()) <= set(SwarmState._ROW_ARRAYS)
    assert set(SwarmState._ROW_FILL) <= set(SwarmState._ROW_ARRAYS)
    for i in range(4):
        st.ensure_row(f"N{i}")
    st.have[2, 5] = True
    st.have_n[2] = 1
    st.island[1] = 3
    st.touch(2)
    st.touch(1)
    st.pend_holder[1, 3, 0] = 2
    st.pend_t[1, 3, 0] = 7.25
    st.pend_cnt[1, 3] = 1
    st.pend_n[1] = 1
    st.pipeline[:4] = 6
    st.opt_peer[3] = 1
    st.uc_rows[0, 0] = 3
    st.uc_n[0] = 1
    st.busy_rows[1, 0] = 2
    st.busy_n[1] = 1
    st.sync_planes()
    i4 = st.ensure_row("N4")
    assert i4 == 4 and st.have.shape[0] == 8
    for name in SwarmState._ROW_ARRAYS:
        assert getattr(st, name).shape[0] == 8, name
    for name in SwarmState._PLANES:
        assert getattr(st, name).shape[0] == 8, name
    assert st.have[2, 5] and int(st.have_n[2]) == 1
    assert int(st.pend_holder[1, 3, 0]) == 2
    assert float(st.pend_t[1, 3, 0]) == 7.25
    assert int(st.pend_cnt[1, 3]) == 1 and int(st.pend_n[1]) == 1
    assert st.pipeline[:4].tolist() == [6] * 4
    assert int(st.opt_peer[3]) == 1
    assert int(st.uc_rows[0, 0]) == 3 and int(st.busy_rows[1, 0]) == 2
    # planes kept their synced rows through the growth
    assert int(st.have_d[2, 5]) == 1 and int(st.have_d[:, :].sum()) == 1
    assert int(st.island_d[1]) == 3
    assert st.alive_d[:4].tolist() == [1, 1, 1, 1]
    st.sync_planes()
    assert st.alive_d.tolist() == [1, 1, 1, 1, 1, 0, 0, 0]
    assert not st.have[5:].any() and not st.alive[5:].any()
    assert (st.opt_peer[5:] == -1).all()
    assert (st.pend_holder[5:] == -1).all()
    assert (st.uc_rows[5:] == -1).all()
    assert (st.ub_rows[5:] == -1).all()
    assert (st.busy_rows[5:] == -1).all()
    assert int(st.pend_cnt[5:].sum()) == 0


# ============= one pump from a reference hub's mid-run state ============ #
def _reference_pump_capture(p4p):
    """Run a reference batched flash crowd and capture, at the first pump
    after t=5 s that issues requests, the pump's input state as plain
    numpy together with the reference's orders and fused decisions for
    every live fetching row."""
    from repro.core import (Agent as RAgent, AgentConfig as RConfig,
                            LinkModel as RLink, SimRuntime as RRuntime,
                            SwarmHub as RHub, Topology as RTopology,
                            TrackerConfig as RTConfig,
                            TrackerServer as RTracker,
                            make_prime_app as r_make_app)
    from repro.core import swarm_kernels as rsk
    names = ["host"] + [f"L{i:02d}" for i in range(16)]
    topo = RTopology.make(names, 3, seed=4) if p4p else None
    rt = RRuntime(link=RLink(uplink_Bps=12.5e6, downlink_Bps=12.5e6),
                  topology=topo)
    rt.add_node(RTracker(config=RTConfig(ping_interval_s=2.0),
                         topology=topo))
    hub = RHub(backend="numpy")
    if p4p:
        hub.set_topology(topo)
    host = RAgent("host", config=RConfig(work_timeout_s=600.0), hub=hub)
    rt.add_node(host)
    host.host_app(r_make_app("sn-app", "host", 3, 6_000, n_parts=8,
                             sim_time_per_number=1e-4, swarm=True,
                             app_bytes=32 * 32_768, piece_bytes=32_768))
    for name in names[1:]:
        rt.add_node(RAgent(name, config=RConfig(work_timeout_s=600.0),
                           hub=hub))
    rt.crash_hooks.append(hub.node_gone)
    cap = {}
    pump = hub._pump

    def capture(st, now):
        if not cap and now >= 5.0:
            n = st.n
            rows = np.nonzero(st.fetching[:n] & st.alive[:n])[0]
            budgets = (st.pipeline[rows] - st.pend_n[rows]).astype(np.int64)
            n_missing = (st.P - st.have_n[rows] - st.pend_n[rows]) \
                .astype(np.int64)
            live = (budgets > 0) & (n_missing > 0)
            rows, budgets, n_missing = rows[live], budgets[live], \
                n_missing[live]
            missing = ~st.have[rows, :] & ~(st.pend_cnt[rows, :] > 0)
            if p4p:
                orders = rsk.cost_orders(
                    missing, st.counts, st.offsets[rows],
                    hub._piece_cost(st, rows), st.P, backend="numpy")
            else:
                orders = rsk.rarest_orders(missing, st.counts,
                                           st.offsets[rows], st.P,
                                           backend="numpy")
            dec = [None] * rows.size
            starved = np.zeros(rows.size, dtype=bool)
            hub._match_fast(st, rows, np.arange(rows.size), orders,
                            budgets, n_missing, dec, starved)
            if sum(len(d) for d in dec):
                arrays = {name: np.array(getattr(st, name))
                          for name in SwarmState._ROW_ARRAYS}
                arrays.update(counts=np.array(st.counts),
                              names=list(st.names), P=st.P)
                cap.update(arrays=arrays, rows=rows, budgets=budgets,
                           n_missing=n_missing, missing=missing,
                           orders=orders, dec=dec, starved=starved,
                           cost=hub.cost_matrix)
        pump(st, now)

    hub._pump = capture
    rt.run_batched(until=120.0, stop_when=lambda: bool(cap), tick_s=0.5,
                   on_tick=hub.tick)
    assert cap, "no pump with requests was captured"
    return cap, names


@pytest.mark.parametrize("p4p", [False, True])
def test_load_state_arrays_gives_reference_orders_and_picks(p4p):
    cap, names = _reference_pump_capture(p4p)
    arrays = cap["arrays"]
    hub = SwarmHub(device="cpu")
    if p4p:
        from repro_torch.core import Topology
        hub.set_topology(Topology.make(names, 3, seed=4))
        assert np.array_equal(hub.cost_matrix, cap["cost"])
    st = SwarmState("sn-app", SimpleNamespace(n_pieces=int(arrays["P"])),
                    capacity=arrays["have"].shape[0],
                    dup_slots=arrays["pend_holder"].shape[2], device="cpu")
    load_state_arrays(st, arrays)
    assert st.n == len(names)
    for plane, host in SwarmState._PLANES.items():
        assert np.array_equal(getattr(st, plane).numpy(),
                              arrays[host].astype(
                                  getattr(st, plane).numpy().dtype))
    rows = cap["rows"]
    assert rows.size >= 4
    orders_d = hub._orders(st, rows, cap["missing"])
    assert np.array_equal(orders_d.numpy(), cap["orders"])
    dec = [None] * rows.size
    starved = np.zeros(rows.size, dtype=bool)
    hub._match_fast(st, rows, np.arange(rows.size), orders_d,
                    orders_d.numpy(), cap["budgets"], cap["n_missing"], dec,
                    starved)
    assert dec == cap["dec"]
    assert np.array_equal(starved, cap["starved"])
    assert sum(len(d) for d in dec) > 0


# ============ the P4P cost rows against the reference hub =============== #
@pytest.mark.parametrize("n_islands,empty", [(1, 0), (3, 0), (8, 0), (8, 3)])
def test_piece_cost_matches_reference_hub(n_islands, empty):
    """A CPU hub with a topology gives the reference hub's `_piece_cost`
    on the same state: dead rows, full rows (alive and dead), islands
    with no member (``empty`` of them), leecher rows in any order."""
    from repro.core import SwarmHub as RHub, Topology as RTopology
    from repro.core.swarm_arrays import SwarmState as RState
    from repro_torch.core import Topology
    rs = np.random.default_rng(40 + n_islands + empty)
    n, P = 90, 48
    names = [f"V{i:03d}" for i in range(n)]
    rhub = RHub(backend="numpy")
    rhub.set_topology(RTopology.make(names, n_islands, seed=6))
    hub = SwarmHub(device="cpu")
    hub.set_topology(Topology.make(names, n_islands, seed=6))
    assert np.array_equal(hub.cost_matrix, rhub.cost_matrix)
    manifest = SimpleNamespace(n_pieces=P)
    rst = RState("a", manifest, capacity=128)
    st = SwarmState("a", manifest, capacity=128, device="cpu")
    have = rs.random((n, P)) < 0.1
    full, alive = rs.random(n) < 0.1, rs.random(n) < 0.8
    island = rs.integers(0, n_islands - empty, n)
    for s in (rst, st):
        s.n = n
        s.have[:n], s.full[:n], s.alive[:n] = have, full, alive
        s.island[:n] = island
    st.plane_dirty.update(range(n))
    st.sync_planes()
    rows = rs.permutation(n)[:57]
    want = rhub._piece_cost(rst, rows)
    got = hub._piece_cost(st, torch.from_numpy(rows.astype(np.int64)))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)
