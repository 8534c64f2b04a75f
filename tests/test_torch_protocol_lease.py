"""Lease lifecycle: drop_volunteer, TAIL expiry re-DIST, BYE reclamation.

The reference's `tests/test_lease_lifecycle.py`, run on
`repro_torch.core` on the CPU."""
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.protocol

from repro_torch.core import (Agent, AgentConfig, LeaseTable, SimRuntime,
                              TrackerConfig, TrackerServer, make_prime_app)


# --------------------------- LeaseTable unit --------------------------- #
def test_drop_volunteer_frees_leases():
    tail = LeaseTable(timeout_s=60.0)
    tail.grant(0, "a", now=0.0)
    tail.grant(1, "a", now=0.0)
    tail.grant(1, "b", now=0.0)
    freed = tail.drop_volunteer("a")
    assert sorted(freed) == [0, 1]
    active = tail.active()
    assert 0 not in active
    assert [l.volunteer_id for l in active[1]] == ["b"]
    # dropping an unknown volunteer is a no-op
    assert tail.drop_volunteer("zz") == []


def test_lease_expiry_and_release():
    tail = LeaseTable(timeout_s=10.0)
    tail.grant(3, "a", now=0.0)
    assert tail.expired(5.0) == []
    exp = tail.expired(10.0)
    assert [l.part_id for l in exp] == [3]
    assert tail.release(3, "a")
    assert not tail.release(3, "a")      # already released


# ------------------------- protocol behaviours ------------------------- #
def build_cloud(n_leechers=2, parts=24, timeout=200.0, tmp=None,
                max_missed=3, per_number=1e-4):
    rt = SimRuntime()
    server = TrackerServer(config=TrackerConfig(ping_interval_s=2.0,
                                                max_missed=max_missed))
    rt.add_node(server)
    host = Agent("host", config=AgentConfig(work_timeout_s=timeout,
                                            root_dir=tmp))
    rt.add_node(host)
    app = make_prime_app("app", "host", 3, 24_000, n_parts=parts,
                         sim_time_per_number=per_number)
    host.host_app(app)
    leechers = []
    for i in range(n_leechers):
        a = Agent(f"L{i}", config=AgentConfig(work_timeout_s=timeout))
        rt.add_node(a)
        leechers.append(a)
    return rt, server, host, app, leechers


def test_tail_expiry_redistributes_to_other_volunteer(tmp_path):
    # slow parts (~8s each) and death detection disabled (max_missed huge):
    # TAIL expiry is the only mechanism recovering the dead node's lease
    rt, server, host, app, leechers = build_cloud(parts=30, timeout=30.0,
                                                  tmp=str(tmp_path),
                                                  max_missed=10**9,
                                                  per_number=1e-2)
    rt.run(until=5)
    dead = leechers[0]
    # silent death: no BYE — only TAIL expiry can recover its leases
    del rt.nodes[dead.node_id]
    rt.run(until=3600 * 5, stop_when=lambda: app.done)
    assert app.done
    assert all(p.done for p in app.parts)
    # the survivor picked up real work, including parts originally leased
    # to the dead volunteer
    assert leechers[1].completed_cycles["app"] > 0
    survivor = {leechers[1].node_id}
    assert any(v in survivor for p in app.parts for v, _, _ in p.results)
    log = (tmp_path / "host" / "Seed" / "App" / "app" / "Data" /
           "Tracker").read_text()
    # a lease visibly expired via TAIL and the part was re-DISTed
    assert "lease" in log
    assert "timeout" in log


def test_bye_reclaims_leases_immediately():
    # long timeout: if BYE did not reclaim, the app could not finish soon
    rt, server, host, app, leechers = build_cloud(parts=20, timeout=3000.0)
    rt.run(until=3)
    quitter = leechers[0]
    quitter.shutdown()                  # sends BYE
    del rt.nodes[quitter.node_id]
    rt.run(until=rt.now() + 5)
    # server dropped the member and the host freed its leases
    assert quitter.node_id not in server.members
    active = host.tails["app"].active()
    for leases in active.values():
        assert all(l.volunteer_id != quitter.node_id for l in leases)
    rt.run(until=2000, stop_when=lambda: app.done)
    assert app.done
    assert rt.now() < 2000.0            # far sooner than the 3000s timeout


def test_missed_pings_broadcast_peer_gone():
    rt, server, host, app, leechers = build_cloud(parts=40, timeout=3000.0)
    rt.run(until=3)
    dead = leechers[0]
    del rt.nodes[dead.node_id]          # silent death, no BYE
    # after (max_missed + 1) pings the tracker declares it gone and the
    # host reclaims the leases well before the 3000s TAIL timeout
    rt.run(until=rt.now() + 15)
    assert dead.node_id not in server.members
    active = host.tails["app"].active()
    for leases in active.values():
        assert all(l.volunteer_id != dead.node_id for l in leases)
