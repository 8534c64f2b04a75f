"""Bitmask-native swarm hot paths: incremental availability bookkeeping,
differential equivalence with the reference implementation, rolling-rate
choke ranking, piece-cache rescan, zero-copy images, timer versioning.

The reference's `tests/test_exchange_scaling.py`, run on
`repro_torch.core` on the CPU.  Scenario VII's smoke runs the port's
`scenarios.scenario_vii` with ``device="cpu"``."""
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.protocol

from repro_torch.core import (Agent, AgentConfig, LinkModel, Msg,
                              PieceExchange, PieceManifest, RollingRate,
                              SimRuntime, TrackerConfig, TrackerServer,
                              iter_bits, make_prime_app, rarest_first_order,
                              rarest_first_order_np)
from repro_torch.core.directory import AgentDirs
from repro_torch.core.messages import HAVE, PIECE_DATA, PIECE_REQ, UNCHOKE
from repro_torch.core.runtime import Node


def _engine(node_id="L", incremental=True, clock=None, dirs=None, **over):
    cfg = AgentConfig(**over)
    log = []
    px = PieceExchange(node_id, cfg,
                       send=lambda dst, msg: log.append((dst, msg)),
                       now=(lambda: clock[0]) if clock else (lambda: 0.0),
                       tracker_id="server", dirs=dirs)
    px.use_incremental = incremental
    return px, log


# ------------------ differential: availability array ------------------- #
def _naive_avail(px, app_id, n_pieces):
    """Recompute availability from scratch out of the engine's raw state:
    full-seeder count plus per-piece partial-holder counts."""
    full = (1 << n_pieces) - 1
    avail = np.zeros(n_pieces, dtype=np.int32)
    for mask in px.peer_masks.get(app_id, {}).values():
        for p in iter_bits(mask & full):
            avail[p] += 1
    avail += np.int32(len(px.full_seeders.get(app_id, ())))
    return avail


def test_incremental_availability_matches_naive_recompute():
    """500 randomized HAVE / SEEDER_UPDATE / PEER_GONE events: the
    incrementally maintained count array stays byte-identical to a naive
    recompute after every single event."""
    n_pieces = 96
    px, _ = _engine()
    manifest = PieceManifest.synthetic("a", n_pieces * 500, 500)
    px.join("a", manifest)
    rng = random.Random(7)
    peers = [f"P{i}" for i in range(24)]
    for step in range(500):
        roll = rng.random()
        if roll < 0.70:
            # masks occasionally carry out-of-range bits (a buggy or
            # malicious announce); they must be ignored consistently
            mask = rng.getrandbits(n_pieces + 8)
            px.on_have(Msg(HAVE, rng.choice(peers),
                           {"app_id": "a", "mask": mask}))
        elif roll < 0.85:
            k = rng.randrange(0, 6)
            px.note_full_seeders("a", set(rng.sample(peers, k)))
        else:
            px.on_peer_gone(rng.choice(peers))
        got = px.avail_array("a")
        want = _naive_avail(px, "a", n_pieces)
        assert got.dtype == np.int32
        assert got.tobytes() == want.tobytes(), f"diverged at step {step}"


def test_pre_manifest_garbage_mask_survives_join_and_departure():
    """A HAVE can precede the manifest; its mask is stored untrimmed.
    Learning the manifest, promoting the peer, and the peer's departure
    must all ignore the out-of-range bits instead of corrupting (or
    crashing on) the availability counts."""
    n_pieces = 8
    manifest = PieceManifest.synthetic("a", n_pieces * 100, 100)
    px, _ = _engine()
    garbage = (1 << 40) | 0b101          # bits far beyond n_pieces
    px.on_have(Msg(HAVE, "P0", {"app_id": "a", "mask": garbage}))
    px.on_have(Msg(HAVE, "P1", {"app_id": "a",
                                "mask": (1 << 33) | manifest.full_mask}))
    px.interested["a"].add("P1")         # INTERESTED raced ahead too
    px.unchoked["a"].add("P1")
    px.join("a", manifest)
    # P1's in-range holdings are complete: promoted despite garbage bits,
    # and the late promotion still releases its upload slot
    assert "P1" in px.full_seeders["a"]
    assert "P1" not in px.interested["a"]
    assert "P1" not in px.unchoked["a"]
    want = np.zeros(n_pieces, dtype=np.int32)
    want[[0, 2]] += 1                    # P0's in-range bits
    want += 1                            # P1's partial-holder counts
    want += 1                            # …plus its full-seeder constant
    assert px.avail_array("a").tobytes() == want.tobytes()
    px.on_peer_gone("P0")                # must not IndexError
    px.on_peer_gone("P1")
    want = np.zeros(n_pieces, dtype=np.int32)
    assert px.avail_array("a").tobytes() == want.tobytes()
    # departed peers' rate estimators are dropped as well
    px._credit_from("P2", 1_000)
    px.on_peer_gone("P2")
    assert "P2" not in px.rate_from


def test_rarest_first_order_np_matches_scalar():
    rng = random.Random(3)
    for _ in range(50):
        n = rng.randrange(1, 120)
        counts = np.array([rng.randrange(0, 6) for _ in range(n)],
                          dtype=np.int32)
        missing = sorted(rng.sample(range(n), rng.randrange(0, n + 1)))
        off = rng.randrange(0, 300)
        avail = {p: int(counts[p]) for p in range(n)}
        assert rarest_first_order_np(missing, counts, offset=off,
                                     n_pieces=n) \
            == rarest_first_order(missing, avail, offset=off, n_pieces=n)


def test_fast_pump_issues_identical_requests_to_reference():
    """Drive two engines (incremental vs pre-optimization reference)
    through the same randomized event trace; every PIECE_REQ and the
    pending-request tables must match exactly."""
    n_pieces = 64
    manifest = PieceManifest.synthetic("a", n_pieces * 1000, 1000)
    fast, fast_log = _engine(incremental=True, piece_pipeline=6)
    ref, ref_log = _engine(incremental=False, piece_pipeline=6)
    rng = random.Random(23)
    peers = [f"P{i}" for i in range(16)]
    for px in (fast, ref):
        px.join("a", manifest)
        px.note_full_seeders("a", set(peers[:2]))
    for step in range(300):
        roll = rng.random()
        if roll < 0.5:
            ev = Msg(HAVE, rng.choice(peers),
                     {"app_id": "a", "mask": rng.getrandbits(n_pieces)})
            fast.on_have(ev)
            ref.on_have(ev)
        elif roll < 0.8:
            ev = Msg(UNCHOKE, rng.choice(peers), {"app_id": "a"})
            fast.on_unchoke(ev)
            ref.on_unchoke(ev)
        else:
            gone = rng.choice(peers)
            fast.on_peer_gone(gone)
            ref.on_peer_gone(gone)
        assert fast.pending["a"] == ref.pending["a"], f"step {step}"
        assert dict(fast.peer_load) == dict(ref.peer_load), f"step {step}"
    fast_reqs = [(d, m.payload) for d, m in fast_log if m.kind == PIECE_REQ]
    ref_reqs = [(d, m.payload) for d, m in ref_log if m.kind == PIECE_REQ]
    assert fast_reqs == ref_reqs and len(fast_reqs) > 10


def test_peer_load_cleared_when_loaded_peer_departs():
    px, log = _engine(piece_pipeline=2)
    manifest = PieceManifest.synthetic("a", 4_000, 1_000)
    px.join("a", manifest)
    px.note_full_seeders("a", {"A", "B"})
    px.unchoked_by["a"] |= {"A", "B"}
    px.pump("a")
    assert px.peer_load["A"] == 1 and px.peer_load["B"] == 1
    assert len(px.pending["a"]) == 2
    px.on_peer_gone("A")
    # the departed peer's load entry is gone, not just decremented …
    assert "A" not in px.peer_load
    # … and its in-flight request moved to the surviving holder
    assert all(set(asked) == {"B"} for asked in px.pending["a"].values())
    assert px.peer_load["B"] == 1


# ------------------- rolling-rate rechoke ranking ---------------------- #
def test_rolling_rate_estimator_decays_and_stays_bounded():
    rr = RollingRate(window_s=10.0)
    rr.add(0.0, 1000)
    assert rr.rate(1.0) == pytest.approx(100.0)
    assert rr.rate(9.9) == pytest.approx(100.0)
    assert rr.rate(10.1) == 0.0
    # pruning happens on add() too: an estimator that is only ever fed
    # (never ranked) must not retain one entry per transfer forever
    for i in range(1_000):
        rr.add(float(i), 10)
    assert len(rr._events) <= 11
    assert rr.rate(999.0) == pytest.approx(10.0 * 10 / 10.0)


def test_rechoke_prefers_recently_fast_peer_over_stale_fast_peer():
    """Regression for the ROADMAP open item: a peer that moved bytes long
    ago (old-fast) must lose its regular slot to one moving bytes now
    (new-slow-starter), which cumulative counters never allowed."""
    clock = [0.0]
    px, log = _engine("S", clock=clock, upload_slots=2, optimistic_every=99,
                      rate_window_s=20.0)
    manifest = PieceManifest.synthetic("a", 8_000, 1_000)
    px.add_local_app("a", manifest)
    for peer in ("OLD", "NEW", "IDLE"):
        px.on_interested(Msg("INTERESTED", peer, {"app_id": "a"}))
    # t=0: OLD serves us a lot; NEW nothing yet
    px._credit_from("OLD", 50_000)
    clock[0] = 1.0
    px.rechoke()
    regular = px.unchoked["a"] - {px.opt_unchoked.get("a")}
    assert regular == {"OLD"}
    # t=100: OLD went idle (outside the 20s window); NEW serves a little
    clock[0] = 100.0
    px._credit_from("NEW", 2_000)
    px.rechoke()
    regular = px.unchoked["a"] - {px.opt_unchoked.get("a")}
    assert regular == {"NEW"}
    # cumulative totals still favour OLD — the ranking must not
    assert px.bytes_from["OLD"] > px.bytes_from["NEW"]


# --------------------- piece-cache rescan on restart ------------------- #
def test_piece_cache_rescan_restores_partial_and_drops_corrupt(tmp_path):
    image = bytes((i * 13 + 5) % 256 for i in range(8_192))
    manifest = PieceManifest.from_bytes("app", image, piece_bytes=2_048)
    assert manifest.n_pieces == 4
    dirs = AgentDirs(str(tmp_path), "A1")
    # a previous run cached pieces 0 and 2 intact, wrote garbage for 1,
    # and left a foreign file behind
    dirs.save_piece("app", 0, image[:2_048])
    dirs.save_piece("app", 1, b"\xff" * 2_048)            # corrupt
    dirs.save_piece("app", 2, image[4_096:6_144])
    dirs.save_piece("app", 9, b"junk")                    # out of range
    px, log = _engine(dirs=dirs)
    px.join("app", manifest)
    inv = px.inventories["app"]
    # intact pieces restored without any network fetch; bad ones dropped
    assert inv.have == {0, 2}
    assert dirs.load_piece("app", 1) is None
    assert dirs.load_piece("app", 9) is None
    # the join announce advertises the restored holdings
    have = [m for d, m in log if m.kind == HAVE and d == "server"]
    assert have and have[0].payload["mask"] == 0b101
    # only the genuinely missing pieces are fetched; completion reuses the
    # cached pieces byte-for-byte
    px.note_full_seeders("app", {"S"})
    px.unchoked_by["app"].add("S")
    px.pump("app")
    # serve each request as it is issued (one in flight per holder)
    for _ in range(4):
        if inv.complete:
            break
        reqs = [m.payload["piece_id"] for d, m in log
                if m.kind == PIECE_REQ]
        px.on_piece_data(Msg(PIECE_DATA, "S", {
            "app_id": "app", "piece_id": reqs[-1],
            "data": image[reqs[-1] * 2_048:(reqs[-1] + 1) * 2_048]}))
    assert inv.complete
    asked = {m.payload["piece_id"] for d, m in log if m.kind == PIECE_REQ}
    assert asked == {1, 3}               # cached pieces never re-fetched
    assert px.assembled_image("app") == image


def test_piece_cache_rescan_full_cache_completes_without_fetch(tmp_path):
    image = bytes(range(256)) * 16
    manifest = PieceManifest.from_bytes("app2", image, piece_bytes=1_024)
    dirs = AgentDirs(str(tmp_path), "A2")
    for pid in range(manifest.n_pieces):
        dirs.save_piece("app2", pid,
                        image[pid * 1_024:(pid + 1) * 1_024])
    px, log = _engine(dirs=dirs)
    done = []
    px.on_image_complete = lambda *a: done.append(a)
    px.join("app2", manifest)
    assert done and done[0][0] == "app2"
    assert "app2" in px.complete and "app2" not in px.fetching
    assert not any(m.kind == PIECE_REQ for _, m in log)
    assert px.assembled_image("app2") == image


# ------------------- zero-copy shared image buffers -------------------- #
def test_sim_real_image_replicas_share_one_interned_buffer():
    image = bytes((i * 31 + 7) % 256 for i in range(262_144))
    rt = SimRuntime(link=LinkModel(uplink_Bps=12.5e6))
    rt.add_node(TrackerServer(config=TrackerConfig(ping_interval_s=2.0)))
    host = Agent("host", config=AgentConfig(work_timeout_s=600.0))
    rt.add_node(host)
    app = make_prime_app("zc-app", "host", 3, 6_000, n_parts=6,
                         sim_time_per_number=1e-4, swarm=True,
                         piece_bytes=32_768, image=image)
    host.host_app(app)
    leechers = [Agent(f"L{i}", config=AgentConfig(work_timeout_s=600.0))
                for i in range(3)]
    for a in leechers:
        rt.add_node(a)
    rt.run(until=3600, stop_when=lambda: all(
        "zc-app" in a.images for a in leechers))
    base = host.px.image_bytes("zc-app")
    assert isinstance(base, memoryview)
    for l in leechers:
        mv = l.px.image_bytes("zc-app")
        # every replica's image is a view over the SAME buffer object —
        # sim memory stays O(image), not O(N·image)
        assert mv.obj is base.obj
        assert l.px.assembled_image("zc-app") == image
    # pieces served from the origin were zero-copy slices as well
    payload = host.px._piece_payload("zc-app", 1)
    assert isinstance(payload, memoryview) and payload.obj is base.obj


# ----------------------- timer version counters ------------------------ #
def test_sim_timer_latest_set_wins_and_cancel_is_bounded():
    rt = SimRuntime()
    fires = []

    class T(Node):
        node_id = "t"

        def on_timer(self, name):
            fires.append((name, self.rt.now()))

    rt.add_node(T())
    # re-setting the same one-shot supersedes the earlier arm
    rt.set_timer("t", "x", 1.0)
    rt.set_timer("t", "x", 2.0)
    rt.run()
    assert fires == [("x", 2.0)]
    # cancellation
    fires.clear()
    rt.set_timer("t", "y", 1.0)
    rt.cancel_timer("t", "y")
    rt.run()
    assert fires == []
    # a periodic timer stops after cancel, and repeated set/cancel cycles
    # keep exactly one bookkeeping entry per key (no tombstone growth)
    for _ in range(50):
        rt.set_timer("t", "z", 0.5, periodic=True)
        rt.cancel_timer("t", "z")
    assert len(rt._timer_ver) == 3      # keys x, y, z — not 50 tombstones
    fires.clear()
    rt.set_timer("t", "z", 0.5, periodic=True)
    rt.run(until=rt.now() + 1.6)
    assert len(fires) == 3
    rt.cancel_timer("t", "z")
    n = len(fires)
    rt.run(until=rt.now() + 5.0)
    assert len(fires) == n


# ------------------------- scenario VII smoke -------------------------- #
def test_scenario_vii_flash_crowd_smoke():
    from repro_torch.scenarios import scenario_vii
    res = scenario_vii(verbose=False, n_volunteers=8, image_mb=4.0,
                       n_pieces=8, device="cpu")
    assert res["done"] and res["replicated"]
    assert res["replicas"] == 8
    assert res["events"] > 0 and res["events_per_sec"] > 0
    assert res["peak_rss_mb"] > 0
    assert res["full_replication_s"] >= res["makespan_s"] > 0
