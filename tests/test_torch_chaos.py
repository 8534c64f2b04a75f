"""`repro_torch.core.chaos` against the reference `repro.core.chaos`, in one
process: the same fault plans from the same seeds, the same scalar and
batched chaos traces (reports, per-node egress, invariants), the hub's
version-keyed states under upgrades, and the port's own invariant that
the device planes the kernels read equal the host arrays they mirror.

Both packages iterate sets of node-name strings, so their traces agree
inside one process (any hash seed), which is how every test here runs.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro.core.chaos as ref_chaos  # noqa: E402
import repro_torch.core.chaos as port_chaos  # noqa: E402
from repro_torch.core import (AgentConfig, PieceExchange,  # noqa: E402
                              PieceManifest, SwarmHub)

ROOT = Path(__file__).resolve().parents[1]
VOLS = [f"V{i:02d}" for i in range(12)]
# the batched setup of tests/test_swarm_batch.py and the island-aligned
# one of tests/test_topology.py
BATCHED = dict(seed=3, n_volunteers=8, n_pieces=12, n_parts=16,
               image_bytes=96_000, real_image=False, batched=True)
ISLANDS = dict(BATCHED, n_islands=3, island_partitions=True)


def _plan(module, seed, groups):
    return dataclasses.asdict(module.make_chaos_plan(
        seed, VOLS, horizon_s=120.0, churn=0.25 + 0.01 * seed,
        n_partitions=1 + seed % 3, partition_groups=groups))


@pytest.mark.parametrize("seed", range(20))
def test_make_chaos_plan_matches_reference(seed):
    """Crashes, partitions and link faults: identical from the same seed
    and knobs, with random islands and with island-aligned groups."""
    groups = [frozenset(VOLS[k::3]) for k in range(3)] if seed % 2 else None
    want = _plan(ref_chaos, seed, groups)
    assert _plan(port_chaos, seed, groups) == want
    assert want["crashes"] and want["partitions"]


def _strip_wall(report):
    return {k: v for k, v in report.items() if "wall" not in k}


def _run_both(**params):
    """Run one ChaosScenario in each package (the reference batched on
    its numpy backend, the port's on the CPU); the runs must agree on
    the report (wall clocks aside) and on every node's egress, and the
    port's run must pass its invariants."""
    ref_kw = {"backend": "numpy"} if params.get("batched") else {}
    port_kw = {"device": "cpu"} if params.get("batched") else {}
    a = ref_chaos.ChaosScenario(**params, **ref_kw).run()
    b = port_chaos.ChaosScenario(**params, **port_kw).run()
    assert _strip_wall(b.report()) == _strip_wall(a.report())
    assert b.rt.tx_bytes == a.rt.tx_bytes
    assert b.rt.events_processed == a.rt.events_processed
    b.check_invariants()
    return a, b


@pytest.mark.parametrize("seed", range(5))
def test_scalar_chaos_matches_reference(seed):
    """The reference's 20-seed suite setup (N=12, 10% loss, 2% dup, 200 ms
    jitter, 25% churn, one partition), scalar, seeds 0-4."""
    _, b = _run_both(seed=seed)
    r = b.report()
    assert r["replicated"] and r["dropped_msgs"] > 0
    assert r["restarts"] == r["crashes"] > 0


@pytest.mark.parametrize("name,params,batched", [
    ("batched", BATCHED, True),
    ("islands", ISLANDS, True),
    ("islands-scalar", ISLANDS, False),
])
def test_chaos_overlay_matches_reference(name, params, batched):
    """Loss, duplication, jitter, churn and a partition on the batched
    hub (and on islands, with partitions cut along island boundaries):
    the same trace as the reference, and the invariants hold, device
    planes included."""
    _, b = _run_both(**dict(params, batched=batched))
    r = b.report()
    assert r["replicated"] and r["done"]
    if batched:
        assert r["batch_ops"] > 0 and b.hub.device.type == "cpu"
        for st in b.hub.states.values():
            assert port_chaos.stale_planes(st) == []
    if name.startswith("islands"):
        assert r["cross_isp_bytes"] > 0


@pytest.fixture(scope="module")
def batched_run():
    return port_chaos.ChaosScenario(**BATCHED, device="cpu").run()


@pytest.mark.parametrize("host", ["have", "full", "alive", "island"])
def test_plane_invariant_catches_untouched_host_change(batched_run, host):
    """A host row changed without `touch` leaves its device plane behind,
    and check_invariants names the plane; `touch` brings the plane back
    in line."""
    sc = batched_run
    sc.check_invariants()
    st = next(iter(sc.hub.states.values()))
    plane = next(p for p, h in st._PLANES.items() if h == host)
    arr = getattr(st, host)
    i = st.n - 1
    old = arr[i].copy()
    try:
        if host == "have":
            arr[i, 0] = not arr[i, 0]
        elif host == "island":
            arr[i] += 1
        else:
            arr[i] = not arr[i]
        with pytest.raises(AssertionError, match=plane):
            sc.check_invariants()
        st.touch(i)
        assert port_chaos.stale_planes(st) == []
    finally:
        arr[i] = old
        st.touch(i)
    sc.check_invariants()


def test_batched_chaos_without_device_needs_cuda(monkeypatch):
    """`ChaosScenario(batched=True)` defaults to the card and raises where
    there is none; it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        port_chaos.ChaosScenario(**BATCHED)


def test_chaos_cli_batched_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.core.chaos", "--seed", "3",
         "--check", "--batched", "--device", "cpu"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "seed=3: invariants OK" in out.stdout


# ---------- versioned manifests: (app_id, version) state keying --------- #
def _hub_engine(node_id, hub, **over):
    return PieceExchange(node_id, AgentConfig(**over),
                         send=lambda dst, msg: None, now=lambda: 0.0,
                         tracker_id="server", hub=hub)


def test_hub_states_keyed_by_version_never_cross_masks():
    hub = SwarmHub(device="cpu")
    m1 = PieceManifest.synthetic("a", 8_000, 1_000, version=1)
    m2 = PieceManifest.synthetic("a", 8_000, 1_000, version=2, prev=m1,
                                 changed={0})
    seeder = _hub_engine("S", hub)
    seeder.add_local_app("a", m1)
    leech = _hub_engine("L", hub)
    leech.join("a", m2)
    # one state per (app_id, version): the v1 seeder's full mask lives in
    # a different state than the v2 leecher's row
    assert set(hub.states) == {("a", 1), ("a", 2)}
    st2 = hub.states[("a", 2)]
    assert "S" not in st2.row and int(st2.counts.sum()) == 0
    assert hub.has_row("a", "S") and hub.has_row("a", "L")
    assert hub.decide_requests("a", "L", 0.0) == []
    st1 = hub.states[("a", 1)]
    assert st1.full[st1.row["S"]]
    for st in hub.states.values():
        assert port_chaos.stale_planes(st) == []
    assert int(st2.full_d[: st2.n].sum()) == 0
    assert int(st1.full_d[st1.row["S"]]) == 1


def test_hub_retire_detaches_row_and_prunes_empty_state():
    hub = SwarmHub(device="cpu")
    m1 = PieceManifest.synthetic("a", 8_000, 1_000, version=1)
    m2 = PieceManifest.synthetic("a", 8_000, 1_000, version=2, prev=m1,
                                 changed={0})
    a = _hub_engine("A", hub)
    b = _hub_engine("B", hub)
    a.add_local_app("a", m1)
    b.add_local_app("a", m1)
    assert hub.states[("a", 1)].n_alive == 2
    # A upgrades: its engine retires the v1 row and re-registers under v2
    assert a.upgrade("a", m2, full=True)
    st1 = hub.states[("a", 1)]
    assert st1.n_alive == 1 and not st1.alive[st1.row["A"]]
    assert st1.full[st1.row["B"]]                   # only B's claim remains
    assert set(hub.states) == {("a", 1), ("a", 2)}
    # the retired row reaches the device planes as dead and empty
    assert port_chaos.stale_planes(st1) == []
    assert int(st1.alive_d[st1.row["A"]]) == 0
    assert int(st1.full_d[st1.row["A"]]) == 0
    # the last v1 holder upgrading prunes the superseded state entirely:
    # no tick pumps or stages it again
    assert b.upgrade("a", m2, full=True)
    assert set(hub.states) == {("a", 2)}
    st2 = hub.states[("a", 2)]
    assert st2.n_alive == 2
    hub.tick(1.0)
    assert port_chaos.stale_planes(st2) == []
    assert st2.full_d[: st2.n].tolist() == [1, 1]


# ---------- the pump under churn and upgrades: calls per pump ----------- #
@pytest.mark.parametrize("scenario,params", [
    ("scenario_viii", dict(n_volunteers=24, batched=True)),
    ("scenario_x", dict(n_volunteers=24, image_mb=8.0, n_pieces=80,
                        include_chaos=False)),
])
def test_pump_calls_orders_once_and_matcher_at_most_once(monkeypatch,
                                                          scenario, params):
    """Crashes, restarts and upgrades keep the pump's shape: each pump
    that reaches the kernels makes one orders call and at most one
    matcher call, and only states still registered (never one that
    `retire` dropped) are pumped."""
    from repro_torch import scenarios
    from repro_torch.core import swarm_arrays as sa
    calls = {"orders": 0, "match": 0}
    pumps = []

    def counting(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(sa, "rarest_orders",
                        counting("orders", sa.rarest_orders))
    monkeypatch.setattr(sa, "match_requests_ragged",
                        counting("match", sa.match_requests_ragged))
    real_pump = sa.SwarmHub._pump

    def pump(self, st, now):
        assert any(s is st for s in self.states.values())
        before = dict(calls)
        real_pump(self, st, now)
        pumps.append((st.P, calls["orders"] - before["orders"],
                      calls["match"] - before["match"]))

    monkeypatch.setattr(sa.SwarmHub, "_pump", pump)
    res = getattr(scenarios, scenario)(verbose=False, device="cpu",
                                       **params)
    assert res["replicated"]
    ran = [(p, o, m) for p, o, m in pumps if o]
    assert len(ran) > 20
    assert all(o == 1 and m <= 1 for _, o, m in ran)
    assert {p for p, _, _ in ran} == {params.get("n_pieces", 32)}
