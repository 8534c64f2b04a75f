"""Property-based tests (hypothesis) on system invariants.

The reference's `tests/test_property.py`, run on `repro_torch.core` on
the CPU."""
import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.protocol

hypothesis = pytest.importorskip("hypothesis")
import hypothesis.strategies as st  # noqa: E402
from hypothesis import given, settings  # noqa: E402

from repro_torch.core.metrics import AppMetrics
from repro_torch.core.swarm import naive_rounds, plan_broadcast, rounds_of
from repro_torch.core.validation import VotingPool, majority_vote
from repro_torch.core.workunit import (Application, LeaseTable, Part,
                                       find_primes)


# ---------------------------------------------------------------------- #
@given(st.lists(st.integers(0, 3), min_size=1, max_size=15),
       st.integers(1, 5))
def test_majority_vote_winner_has_majority(results, quorum):
    winner, ok = majority_vote(results, quorum=quorum)
    if ok:
        counts = collections.Counter(results)
        assert counts[winner] * 2 > len(results) or len(results) == 1
        assert len(results) >= quorum
    else:
        assert winner is None


@given(st.integers(2, 24), st.integers(2, 24), st.integers(1, 3),
       st.integers(0, 23))
@settings(max_examples=60, deadline=None)
def test_swarm_plan_complete_and_beats_naive(n_nodes, n_pieces, fanout,
                                             seeder):
    seeder = seeder % n_nodes
    plan = plan_broadcast(n_nodes, n_pieces, fanout=fanout, seeder=seeder)
    have = [set() for _ in range(n_nodes)]
    have[seeder] = set(range(n_pieces))
    last_round = 0
    per_round_up = collections.Counter()
    for t in sorted(plan, key=lambda t: t.round):
        assert t.piece in have[t.src], "sender must hold the piece"
        have[t.dst].add(t.piece)
        per_round_up[(t.round, t.src)] += 1
        last_round = max(last_round, t.round)
    assert all(h == set(range(n_pieces)) for h in have), "must complete"
    assert all(v <= fanout for v in per_round_up.values()), "fanout cap"
    if n_nodes > 2:
        assert last_round <= naive_rounds(n_nodes, n_pieces, fanout)


@given(st.lists(st.tuples(st.floats(0.1, 100.0), st.integers(100, 10_000)),
                min_size=1, max_size=50),
       st.integers(1, 4))
def test_metrics_equations(cycles, m_min):
    m = AppMetrics(d_app_bytes=4096, m_min=m_min)
    for t, b in cycles:
        m.record_cycle(b, t)
    n = len(cycles)
    # eq (1) + (4): d = m_min * (sum d_app + sum d_data)
    assert m.d == pytest.approx(m_min * (4096 * n + sum(b for _, b in cycles)))
    # eq (2) + (4)
    assert m.p == m_min * n
    # eq (3): w = m_min * sum(t) / p  == mean(t)  (m_min cancels)
    assert m.w == pytest.approx(sum(t for t, _ in cycles) / n)


@given(st.integers(1, 50), st.integers(1, 5), st.floats(1.0, 100.0))
def test_lease_table_exclusive_and_expiring(n_parts, m, timeout):
    lt = LeaseTable(timeout)
    for pid in range(n_parts):
        for v in range(m):
            lt.grant(pid, f"v{v}", now=0.0)
    active = lt.active()
    assert sum(len(v) for v in active.values()) == n_parts * m
    # all expire exactly at timeout
    assert len(lt.expired(timeout + 1e-6)) == n_parts * m
    assert len(lt.expired(timeout - 1e-3)) == 0
    # dropping one volunteer releases exactly its leases
    parts = lt.drop_volunteer("v0")
    assert len(parts) == n_parts
    assert sum(len(v) for v in lt.active().values()) == n_parts * (m - 1)


@given(st.integers(2, 2000), st.integers(2, 2000))
@settings(max_examples=30, deadline=None)
def test_find_primes_correct(a, b):
    lo, hi = min(a, b), max(a, b)
    out = find_primes(lo, hi)
    for n in out:
        assert n >= 2 and all(n % i for i in range(2, int(n ** 0.5) + 1))
    # spot-check completeness
    for n in range(lo, min(hi, lo + 50)):
        is_p = n >= 2 and all(n % i for i in range(2, int(n ** 0.5) + 1))
        assert (n in out) == is_p


@given(st.integers(1, 3), st.integers(1, 3))
def test_voting_pool_quorum(extra, m_min):
    m_max = m_min + extra
    pool = VotingPool(m_min=m_min, m_max=m_max)
    verdict = None
    for i in range(m_min):
        verdict = pool.offer("k", f"voter{i}", 42)
    assert verdict is not None
    winner, unanimous = verdict
    assert winner == 42 and unanimous


def test_voting_pool_flags_minority():
    pool = VotingPool(m_min=3, m_max=3)
    assert pool.offer("k", "a", 1) is None
    assert pool.offer("k", "b", 1) is None
    winner, unanimous = pool.offer("k", "c", 2)
    assert winner == 1 and not unanimous


# ---------------------------------------------------------------------- #
from repro_torch.cluster.coordinator import JobCoordinator


@given(st.integers(1, 30), st.integers(1, 4))
@settings(max_examples=40, deadline=None)
def test_coordinator_exactly_once(n_items, n_members):
    clock = {"t": 0.0}
    coord = JobCoordinator(lease_timeout_s=10.0, clock=lambda: clock["t"])
    for m in range(n_members):
        coord.join(f"m{m}")
    ids = [coord.submit("data", {"i": i}) for i in range(n_items)]
    done = []
    rounds = 0
    while coord.outstanding and rounds < 10 * n_items:
        rounds += 1
        for m in range(n_members):
            item = coord.request(f"m{m}")
            if item is not None:
                ok = coord.complete(f"m{m}", item.item_id, elapsed_s=1.0)
                if ok:
                    done.append(item.item_id)
        clock["t"] += 1.0
    assert sorted(done) == sorted(ids)          # exactly once each
    assert coord.outstanding == 0


def test_coordinator_lease_expiry_redispatch():
    clock = {"t": 0.0}
    coord = JobCoordinator(lease_timeout_s=5.0, clock=lambda: clock["t"])
    coord.join("a")
    coord.join("b")
    iid = coord.submit("data", {})
    item = coord.request("a")
    assert item.item_id == iid
    # "a" dies; lease expires; "b" can pick it up
    clock["t"] = 6.0
    assert coord.expire_leases() == [iid]
    item2 = coord.request("b")
    assert item2.item_id == iid
    assert coord.complete("b", iid)


def test_heartbeat_t_f_semantics():
    from repro_torch.cluster.heartbeat import HeartbeatMonitor, MemberState
    clock = {"t": 0.0}
    dead = []
    hb = HeartbeatMonitor(t_interval_s=1.0, f_max_missed=3,
                          on_dead=dead.append, clock=lambda: clock["t"])
    hb.register("x")
    clock["t"] = 2.5
    hb.sweep()
    assert hb.members["x"].state == MemberState.SUSPECT
    hb.beat("x")
    hb.sweep()
    assert hb.members["x"].state == MemberState.ALIVE
    clock["t"] = 2.5 + 4.5   # > f*t since last beat
    assert hb.sweep() == ["x"]
    assert dead == ["x"]
