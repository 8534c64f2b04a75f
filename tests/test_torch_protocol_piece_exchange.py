"""PieceExchange engine: choke scheduling, endgame cancels, real bytes.

The reference's `tests/test_piece_exchange.py`, run on
`repro_torch.core` on the CPU."""
import threading
import time

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.protocol

from repro_torch.core import (Agent, AgentConfig, LinkModel, Msg,
                              PieceExchange, PieceManifest, SimRuntime,
                              ThreadRuntime, TrackerConfig, TrackerServer,
                              make_prime_app, mask_nbytes, mask_of,
                              pieces_of, rarest_first_order)
from repro_torch.core.messages import (CHOKE, HAVE, INTERESTED, PIECE_CANCEL,
                                       PIECE_DATA, PIECE_REQ, UNCHOKE)
from repro_torch.core.runtime import Node
from repro_torch.core.workunit import PieceInventory


# --------------------------- bitmask helpers --------------------------- #
def test_mask_roundtrip_and_sizing():
    pieces = {0, 3, 17, 63}
    mask = mask_of(pieces)
    assert pieces_of(mask) == pieces
    assert mask_of(()) == 0 and pieces_of(0) == set()
    # 64 pieces fit in 8 bytes — announce cost no longer scales O(pieces)
    assert mask_nbytes(mask_of(range(64))) == 8
    assert mask_nbytes(0) == 0


def test_rarest_first_rotation_stable_under_completion():
    # equal availability: the tie-break rotation must not change as the
    # missing set shrinks (the old modulus was len(missing))
    avail = {p: 1 for p in range(8)}
    full = rarest_first_order(list(range(8)), avail, offset=5, n_pieces=8)
    shrunk = rarest_first_order([p for p in full if p != full[0]],
                                avail, offset=5, n_pieces=8)
    assert shrunk == full[1:]


# ----------------------- engine unit: choking -------------------------- #
def _engine(node_id="S", **over):
    cfg = AgentConfig(**over)
    log = []
    px = PieceExchange(node_id, cfg,
                       send=lambda dst, msg: log.append((dst, msg)),
                       now=lambda: 0.0, tracker_id="server")
    return px, log


def _interested(px, app_id, peer):
    px.on_interested(Msg(INTERESTED, peer, {"app_id": app_id}))


def test_choke_fairness_slow_leecher_cannot_monopolize_slots():
    px, log = _engine(upload_slots=2, optimistic_every=2)
    m = PieceManifest.synthetic("a", 64_000, 8_000)
    px.add_local_app("a", m)
    for peer in ("P0", "P1", "P2", "P3"):
        _interested(px, "a", peer)
    # startup fast path filled the free slots first-come-first-served
    assert len(px.unchoked["a"]) == 2
    # P2/P3 reciprocate (serve us bytes, credited through the rolling-rate
    # estimator the rechoke ranking reads); P0/P1 contribute nothing
    px._credit_from("P3", 5_000)
    px._credit_from("P2", 3_000)
    seen = []
    for _ in range(6):
        px.rechoke()
        seen.append(set(px.unchoked["a"]))
        assert len(px.unchoked["a"]) == 2
    # the best reciprocator holds a regular slot in every round…
    assert all("P3" in s for s in seen)
    # …while a zero-contributor can only ever ride the rotating optimistic
    # slot: no slow leecher appears in every round
    for slow in ("P0", "P1"):
        assert not all(slow in s for s in seen)


def test_optimistic_unchoke_rotates_through_choked_peers():
    px, log = _engine(upload_slots=1, optimistic_every=1)
    m = PieceManifest.synthetic("a", 8_000, 1_000)
    px.add_local_app("a", m)
    for peer in ("P0", "P1", "P2"):
        _interested(px, "a", peer)
    opts = []
    for _ in range(6):
        px.rechoke()
        opts.append(px.opt_unchoked["a"])
    # deterministic rotation cycles every choked candidate through the slot
    assert set(opts) == {"P0", "P1", "P2"}
    assert opts[:3] == opts[3:]          # stable cycle


def test_choked_request_is_refused_and_interest_grants_slots():
    px, log = _engine(upload_slots=1)
    m = PieceManifest.synthetic("a", 8_000, 1_000)
    px.add_local_app("a", m)
    _interested(px, "a", "P0")           # takes the only slot
    assert [d for d, msg in log if msg.kind == UNCHOKE] == ["P0"]
    # a non-endgame request from a choked peer bounces with CHOKE
    px.on_piece_req(Msg(PIECE_REQ, "P1", {"app_id": "a", "piece_id": 0}))
    assert (("P1", CHOKE) in [(d, msg.kind) for d, msg in log])
    assert not any(d == "P1" and msg.kind == PIECE_DATA for d, msg in log)
    # an unchoked peer is served
    px.on_piece_req(Msg(PIECE_REQ, "P0", {"app_id": "a", "piece_id": 0}))
    assert any(d == "P0" and msg.kind == PIECE_DATA for d, msg in log)


# ------------------- engine unit: endgame + cancels -------------------- #
def _wire(engines):
    """Deliver engine->engine messages through an inspectable queue."""
    history = []
    queue = []

    def mksend():
        return lambda dst, msg: queue.append((dst, msg))

    def pump():
        handlers = {PIECE_REQ: "on_piece_req", PIECE_DATA: "on_piece_data",
                    HAVE: "on_have", INTERESTED: "on_interested",
                    CHOKE: "on_choke", UNCHOKE: "on_unchoke",
                    PIECE_CANCEL: "on_piece_cancel"}
        while queue:
            dst, msg = queue.pop(0)
            history.append((dst, msg))
            eng = engines.get(dst)
            if eng is not None:
                getattr(eng, handlers[msg.kind])(msg)
    return mksend, pump, history


def test_endgame_duplicates_and_piece_cancel_reconciliation():
    engines = {}
    mksend, pump, history = _wire(engines)
    # two pieces: endgame engages for the tail piece once the first
    # verified (no duplication of a transfer's very first requests)
    m = PieceManifest.synthetic("a", 2_000, 1_000)
    L = PieceExchange("L", AgentConfig(endgame=True, endgame_dup=2),
                      send=mksend(), now=lambda: 0.0)
    A = PieceExchange("A", AgentConfig(choke=False),
                      send=mksend(), now=lambda: 0.0)
    B = PieceExchange("B", AgentConfig(upload_slots=1),
                      send=mksend(), now=lambda: 0.0)
    engines.update({"L": L, "A": A, "B": B})
    A.add_local_app("a", m)
    B.add_local_app("a", m)
    B.interested["a"].add("X")           # B's only upload slot is taken…
    B.unchoked["a"].add("X")
    done = []
    L.on_image_complete = lambda *args: done.append(args)
    L.join("a", m)
    L.note_full_seeders("a", {"A", "B"})
    L.pump("a")
    pump()       # full exchange: handshake, request, endgame dup, cancel
    # the missing piece went to A (first UNCHOKE); endgame duplicated the
    # request to B, flagged so B parks it in its choke queue
    endgame_reqs = [(d, msg) for d, msg in history
                    if msg.kind == PIECE_REQ and msg.payload.get("endgame")]
    assert [d for d, _ in endgame_reqs] == ["B"]
    assert not B.queued_reqs["a"].get("L")
    # A won the race: L cancelled the duplicate parked at B…
    assert L.cancels_sent == 1
    assert any(d == "B" and msg.kind == PIECE_CANCEL for d, msg in history)
    # …so B never transmitted the piece, even after X frees the slot
    B.unchoked["a"].discard("X")
    B._maybe_unchoke_now("a")
    pump()
    assert not any(msg.kind == PIECE_DATA and msg.src == "B"
                   for _, msg in history)
    assert done and done[0][0] == "a"    # image completed exactly once
    assert L.inventories["a"].complete


# ------------------ SimRuntime: downlink + cancel_work ----------------- #
def test_downlink_contention_serializes_bulk_ingress():
    got = []

    class Sink(Node):
        node_id = "sink"

        def on_message(self, msg):
            got.append((msg.payload["i"], self.rt.now()))

    link = LinkModel(uplink_Bps=None, downlink_Bps=1e6, base_latency_s=0.0,
                     bandwidth_Bps=1e9, bulk_threshold_bytes=1 << 16)
    rt = SimRuntime(link=link)
    rt.add_node(Sink())
    # 1MB from two different senders: both arrive via the sink's downlink
    rt.send("sink", Msg("X", "src1", {"i": 0}, size_bytes=1_000_000))
    rt.send("sink", Msg("X", "src2", {"i": 1}, size_bytes=1_000_000))
    rt.send("sink", Msg("X", "src3", {"i": 2}, size_bytes=64))
    rt.run()
    at = dict(got)
    assert at[0] == pytest.approx(1.0, rel=0.01)
    assert at[1] == pytest.approx(2.0, rel=0.01)   # queued at the ingress
    assert at[2] < 0.1                             # control msgs interleave


def test_sim_runtime_cancel_work_removes_job():
    done = []

    class W(Node):
        node_id = "w"

        def on_work_done(self, tag, result, elapsed_s):
            done.append((tag, self.rt.now()))

    rt = SimRuntime()
    w = W()
    rt.add_node(w)
    rt.submit_work("w", "t1", None, sim_duration_s=5.0)
    rt.submit_work("w", "t2", None, sim_duration_s=5.0)
    assert rt.cancel_work("w", "t1")
    assert not rt.cancel_work("w", "missing")
    rt.run()
    # t1 never completes; t2 reclaims the whole core (10s if t1 had stayed)
    assert [t for t, _ in done] == ["t2"]
    assert done[0][1] == pytest.approx(5.0, abs=0.2)


# -------------- integration: PART_CANCEL caps duplicates --------------- #
def _run_swarm_mmin2(endgame: bool):
    rt = SimRuntime(link=LinkModel(uplink_Bps=12.5e6))
    server = TrackerServer(config=TrackerConfig(ping_interval_s=2.0))
    rt.add_node(server)
    cfg = dict(work_timeout_s=600.0, endgame=endgame)
    host = Agent("host", config=AgentConfig(**cfg))
    rt.add_node(host)
    image = int(4e6)
    app = make_prime_app("app", "host", 3, 24_000, n_parts=16,
                         sim_time_per_number=5e-3, m_min=2, swarm=True,
                         app_bytes=image, piece_bytes=image // 8)
    host.host_app(app)
    agents = [host]
    for i in range(6):
        a = Agent(f"L{i}", config=AgentConfig(**cfg))
        # heterogeneous volunteers (cf. paper Scenario IV): staggered
        # completion times are what give cancels something to abort
        rt.add_node(a, speed=1.0 - 0.08 * i)
        agents.append(a)
    rt.run(until=4 * 3600, stop_when=lambda: app.done)
    assert app.done
    import collections
    execs = collections.Counter(part_id for a in agents
                                for (_, aid, part_id) in a.results_log
                                if aid == "app")
    return app, agents, execs


def test_part_cancel_caps_duplicate_executions():
    app, agents, execs = _run_swarm_mmin2(endgame=True)
    # endgame reconciliation: no part runs to completion more than
    # m_min + 1 times (one duplicate may slip through the cancel latency)
    assert max(execs.values()) <= app.m_min + 1
    # every part still reached its m_min quorum at its owner seeder
    # (results converge there; other seeders learn via PART_DONE gossip)
    copies = [c for a in agents
              for c in (a.apps.get("app"), a.replicas.get("app")) if c]
    for part in app.parts:
        assert part.done
        assert any(len(c.parts[part.part_id].results) >= app.m_min
                   for c in copies)
    dup_with = sum(max(0, n - app.m_min) for n in execs.values())
    _, _, execs_base = _run_swarm_mmin2(endgame=False)
    dup_without = sum(max(0, n - app.m_min) for n in execs_base.values())
    assert dup_with <= dup_without


def test_corrupt_piece_rerouted_to_other_holder_immediately():
    px, log = _engine("L")
    m = PieceManifest.synthetic("a", 1_000, 1_000)       # one piece
    px.join("a", m)
    px.note_full_seeders("a", {"A", "B"})
    px.unchoked_by["a"] |= {"A", "B"}
    px.pump("a")
    assert set(px.pending["a"][0]) == {"A"}              # least-loaded first
    # A serves garbage: the piece must re-enter missing and go to B now,
    # not stall until the recover() timeout
    px.on_piece_data(Msg(PIECE_DATA, "A",
                         {"app_id": "a", "piece_id": 0,
                          "proof": "garbage", "mask": 1}))
    assert "A" in px.bad_peers["a"]
    assert set(px.pending["a"][0]) == {"B"}
    reqs = [(d, msg) for d, msg in log if msg.kind == PIECE_REQ]
    assert [d for d, _ in reqs] == ["A", "B"]


def test_phantom_full_seeder_demoted_on_unchanged_snapshot():
    """Live-lock regression (scenario-x chaos overlay, hash-seed
    dependent): a crash-restarted seeder the tracker still advertises
    keeps refusing re-requests with an authoritative HAVE identical to
    the mask we already recorded.  The no-change early return in
    `_sync_peer_mask` used to skip the full-seeder demote, so `_holders`
    kept offering the phantom seeder and the REQ -> "don't have it" HAVE
    -> re-route -> REQ cycle spun at link latency while the heap grew."""
    px, log = _engine("L")
    m = PieceManifest.synthetic("a", 1_000, 1_000)       # one piece
    px.join("a", m)
    px.note_full_seeders("a", {"A"})                     # stale tracker row
    px.unchoked_by["a"].add("A")
    px.pump("a")
    assert [d for d, msg in log if msg.kind == PIECE_REQ] == ["A"]
    # A restarted empty: an authoritative snapshot (direct HAVE, no relay
    # hop) says it holds nothing — first contact records mask 0, and the
    # re-route still re-asks A because full_seeders vouches for it
    px.on_have(Msg(HAVE, "A", {"app_id": "a", "mask": 0, "v": m.version}))
    px.note_full_seeders("a", {"A"})                     # tracker re-push
    n_reqs = sum(1 for _, msg in log if msg.kind == PIECE_REQ)
    # the identical snapshot again: the demote must fire even though the
    # mask did not change, breaking the cycle on the second bounce
    px.on_have(Msg(HAVE, "A", {"app_id": "a", "mask": 0, "v": m.version}))
    assert "A" not in px.full_seeders["a"]
    assert px._holders("a", 0) == []
    assert sum(1 for _, msg in log if msg.kind == PIECE_REQ) == n_reqs
    assert 0 not in px.pending.get("a", {})


def test_recover_rerequests_stale_piece_from_alternate_holder():
    """The pending staleness sweep: a PIECE_DATA that never arrives is
    withdrawn after `stall_s` (PIECE_CANCEL to the silent holder, load
    released) and re-requested from an ALTERNATE holder — the silent one
    is shunned for that piece, so a black-holed link cannot capture the
    retries forever."""
    clock = [0.0]
    cfg = AgentConfig()
    log = []
    px = PieceExchange("L", cfg, send=lambda d, m: log.append((d, m)),
                       now=lambda: clock[0], tracker_id="server")
    m = PieceManifest.synthetic("a", 1_000, 1_000)       # one piece
    px.join("a", m)
    px.note_full_seeders("a", {"A", "B"})
    px.unchoked_by["a"] |= {"A", "B"}
    px.pump("a")
    assert set(px.pending["a"][0]) == {"A"}              # name tie-break
    assert px.peer_load["A"] == 1
    # A never answers: after the stall the request is withdrawn …
    clock[0] = 10.0
    px.recover("a", stall_s=5.0)
    assert [d for d, msg in log if msg.kind == PIECE_CANCEL] == ["A"]
    assert px.peer_load["A"] == 0
    # … and re-issued to B, not back to the silent A
    reqs = [d for d, msg in log if msg.kind == PIECE_REQ]
    assert reqs == ["A", "B"]
    assert set(px.pending["a"][0]) == {"B"}
    # B serves it: the piece completes and the stale history is dropped
    px.on_piece_data(Msg(PIECE_DATA, "B",
                         {"app_id": "a", "piece_id": 0,
                          "proof": m.piece_hashes[0], "mask": 1}))
    assert px.inventories["a"].complete
    assert 0 not in px.stalled_holders.get("a", {})


def test_recover_reannounces_when_no_holder_unchokes():
    """A leecher whose join HAVE died on the wire re-announces to the
    tracker from the staleness sweep, instead of waiting forever for a
    swarm that never learned it exists."""
    clock = [0.0]
    log = []
    px = PieceExchange("L", AgentConfig(),
                       send=lambda d, m: log.append((d, m)),
                       now=lambda: clock[0], tracker_id="server")
    m = PieceManifest.synthetic("a", 2_000, 1_000)
    px.join("a", m)
    assert [d for d, msg in log if msg.kind == HAVE] == ["server"]
    clock[0] = 30.0
    px.recover("a", stall_s=5.0)
    # no holder ever unchoked us -> interest cleared + HAVE re-announced
    assert [d for d, msg in log if msg.kind == HAVE] == ["server", "server"]


def test_repeated_interest_repeats_lost_unchoke():
    px, log = _engine(upload_slots=2)
    m = PieceManifest.synthetic("a", 8_000, 1_000)
    px.add_local_app("a", m)
    _interested(px, "a", "P0")
    assert [d for d, msg in log if msg.kind == UNCHOKE] == ["P0"]
    # P0 re-expresses interest (it never saw our UNCHOKE): repeat the
    # grant instead of silently keeping the slot allocated
    _interested(px, "a", "P0")
    assert [d for d, msg in log if msg.kind == UNCHOKE] == ["P0", "P0"]
    assert px.unchoked["a"] == {"P0"}


def test_rejected_result_does_not_spin_cached_resend_loop():
    # val_hook persistently rejects part 0: the volunteer's vote is
    # consumed (never re-granted by this seeder) and its cached result is
    # dropped, so no grant->cached-resend->reject livelock forms
    rt = SimRuntime()
    rt.add_node(TrackerServer(config=TrackerConfig(ping_interval_s=2.0)))
    host = Agent("host", config=AgentConfig(work_timeout_s=600.0),
                 val_hook=lambda part_id, result: part_id != 0)
    rt.add_node(host)
    app = make_prime_app("app", "host", 3, 6_000, n_parts=4,
                         sim_time_per_number=1e-3)
    host.host_app(app)
    vol = Agent("V0", config=AgentConfig(work_timeout_s=600.0))
    rt.add_node(vol)
    rt.run(until=120)
    # V0 executed each part at most once; part 0 stays unvalidated but the
    # protocol idles instead of spinning APP_DATA/RESULT traffic
    assert len(vol.results_log) <= len(app.parts)
    assert not app.parts[0].done
    assert all(p.done for p in app.parts[1:])
    assert rt.tx_bytes.get("host", 0) < 1_000_000


# ------------- ThreadRuntime: real bytes, two-seeder fetch ------------- #
def _mk_agent(node_id, tmp, **over):
    cfg = AgentConfig(work_timeout_s=5.0, status_interval_s=0.1,
                      rechoke_interval_s=0.2, root_dir=tmp, **over)
    return Agent(node_id, config=cfg)


def test_thread_runtime_reassembles_real_image_from_two_seeders(tmp_path):
    image = bytes((i * 31 + 7) % 256 for i in range(48_000))
    rt = ThreadRuntime(n_workers=2)
    rt.add_node(TrackerServer(config=TrackerConfig(ping_interval_s=0.2,
                                                   push_interval_s=0.1)))
    host = _mk_agent("h", str(tmp_path))
    app = make_prime_app("app", "h", 3, 1200, n_parts=4, swarm=True,
                         piece_bytes=8_192, image=image)
    host.host_app(app)
    rt.add_node(host)
    l1 = _mk_agent("L1", str(tmp_path))
    rt.add_node(l1)
    # phase 1: L1 fetches the full image from the origin, becomes replica
    rt.run(until_s=20.0, stop_when=lambda: "app" in l1.images)
    assert "app" in l1.images
    assert l1.px.assembled_image("app") == image
    # phase 2: L2 joins with TWO full seeders live and fetches from both
    l2 = _mk_agent("L2", str(tmp_path))
    rt.add_node(l2)
    rt.run(until_s=20.0, stop_when=lambda: "app" in l2.images)
    assert "app" in l2.images
    sources = {peer: n for peer, n in l2.px.pieces_from["app"].items()
               if n > 0}
    assert len(sources) >= 2, f"expected >=2 seeders, got {sources}"
    # byte-for-byte reassembly, re-verified against the manifest hash
    got = l2.px.assembled_image("app")
    assert got == image
    manifest = app.manifest
    assert PieceManifest.from_bytes("app", got,
                                    manifest.piece_bytes).manifest_hash \
        == manifest.manifest_hash
    # the reassembled Seed copy landed on disk (replica serving path)
    seed_copy = tmp_path / "L2" / "Seed" / "App" / "app" / "app.bin"
    assert seed_copy.read_bytes() == image


# ----------------- ThreadRuntime: timer drift regression ---------------- #
def test_thread_runtime_periodic_timer_no_drift_under_message_load():
    rt = ThreadRuntime(n_workers=1)
    fires = []

    class Flood(Node):
        node_id = "flood"

        def start(self, rt):
            super().start(rt)
            rt.set_timer("flood", "tick", 0.05, periodic=True)
            rt.send("flood", Msg("X", "flood"))

        def on_message(self, msg):
            time.sleep(0.04)             # heavy handler hogs the dispatcher
            self.rt.send("flood", Msg("X", "flood"))

        def on_timer(self, name):
            fires.append(self.rt.now())

    rt.add_node(Flood())
    rt.run(until_s=1.2)
    # deadline-aware dispatch + scheduled-time re-arm keep the 50ms grid:
    # ~24 fires expected; the old drift-per-period loop managed ~17
    assert len(fires) >= 20, f"only {len(fires)} fires: drift under load"


# ============ versioned manifests: delta + mixed-version ================ #
def test_manifest_chain_supersedes_and_delta():
    img1 = bytes(range(256)) * 16                    # 4096 bytes, 4 pieces
    m1 = PieceManifest.from_bytes("a", img1, 1024)
    img2 = bytearray(img1)
    img2[2048] ^= 0xFF                               # flip a byte in piece 2
    m2 = PieceManifest.from_bytes("a", bytes(img2), 1024, version=2, prev=m1)
    assert m2.prev_manifest_hash == m1.manifest_hash
    assert m2.manifest_hash != m1.manifest_hash      # hash folds the chain
    assert m2.delta(m1) == {2}
    assert m2.supersedes(m1) and not m1.supersedes(m2)
    assert not m1.supersedes(m1)                     # strictly newer only
    assert m2.supersedes(None)
    other = PieceManifest.from_bytes("b", img1, 1024, version=9)
    assert not other.supersedes(m1)                  # different app
    # incomparable manifests conservatively report everything changed
    coarse = PieceManifest.from_bytes("a", img1, 2048, version=2, prev=m1)
    assert coarse.delta(m1) == set(range(coarse.n_pieces))
    assert m2.delta(None) == {0, 1, 2, 3}


def test_manifest_degenerate_empty_and_exact_multiple():
    # empty image: a 0-piece manifest, trivially complete — no phantom
    # zero-byte piece that could never transfer or verify
    empty = PieceManifest.from_bytes("e", b"", 1024)
    assert empty.n_pieces == 0 and empty.total_bytes == 0
    assert empty.full_mask == 0
    assert PieceInventory(empty).complete
    assert PieceManifest.synthetic("e", 0, 1024).n_pieces == 0
    e2 = PieceManifest.from_bytes("e", b"", 1024, version=2, prev=empty)
    assert e2.supersedes(empty) and e2.delta(empty) == set()
    # exact multiple: no ragged tail piece — the last piece is full-sized
    # and no empty extra piece is appended
    img = bytes(4096)
    exact = PieceManifest.from_bytes("x", img, 1024)
    assert exact.n_pieces == 4
    assert [exact.piece_size(i) for i in range(4)] == [1024] * 4
    syn = PieceManifest.synthetic("x", 4096, 1024)
    assert syn.n_pieces == 4 and syn.piece_size(3) == 1024


def test_upgrade_reuses_unchanged_pieces_and_fetches_delta():
    img1 = bytes((i * 31 + 7) % 256 for i in range(4096))
    m1 = PieceManifest.from_bytes("a", img1, 1024)
    px, log = _engine("S")
    px.add_local_app("a", m1, image=img1)
    img2 = bytearray(img1)
    img2[1030] ^= 0xFF                               # piece 1 changes
    m2 = PieceManifest.from_bytes("a", bytes(img2), 1024, version=2, prev=m1)
    assert px.upgrade("a", m2)
    # the reuse rule carried over every unchanged piece (re-hashed), so
    # only the delta is left to fetch from the swarm
    inv = px.inventories["a"]
    assert inv.have == {0, 2, 3}
    assert px.reused_pieces == 3
    assert "a" in px.fetching and "a" not in px.complete
    # a stale/duplicate publish (not strictly newer) is refused
    assert not px.upgrade("a", m2)
    assert not px.upgrade("a", m1)
    # the missing piece completes the new image through the normal path
    assert inv.add(1, data=bytes(img2[1024:2048]))
    assert inv.complete


def test_stale_have_is_demoted_not_merged():
    m2 = PieceManifest.synthetic("a", 8_000, 1_000, version=2)
    px, log = _engine("S")
    px.add_local_app("a", m2)
    # a crash-restarted peer re-announces its full v1 mask after the
    # swarm moved to v2: it must be demoted, never pooled
    px.on_have(Msg(HAVE, "P1", {"app_id": "a", "mask": 255, "v": 1}))
    assert px.stale_have_demoted == 1
    assert not px.peer_masks.get("a", {}).get("P1", 0)
    # a peer AHEAD of us stops serving our revision: dropped from the
    # pool too, but not counted as a demotion
    px.on_have(Msg(HAVE, "P2", {"app_id": "a", "mask": 255, "v": 3}))
    assert px.stale_have_demoted == 1
    assert not px.peer_masks.get("a", {}).get("P2", 0)
    # the same mask tagged with the current version merges normally
    px.on_have(Msg(HAVE, "P1", {"app_id": "a", "mask": 255, "v": 2}))
    assert px.peer_masks["a"]["P1"] == 255


def test_stale_piece_req_refused_with_have():
    m2 = PieceManifest.synthetic("a", 8_000, 1_000, version=2)
    px, log = _engine("S")
    px.add_local_app("a", m2)
    _interested(px, "a", "P0")
    del log[:]
    px.on_piece_req(Msg(PIECE_REQ, "P0",
                        {"app_id": "a", "piece_id": 0, "v": 1}))
    assert px.stale_reqs_refused == 1
    # refused with our (version-tagged) HAVE so the straggler learns of
    # the new revision — never served stale-as-fresh, never banned
    assert not any(m.kind == PIECE_DATA for _, m in log)
    sent = [m for d, m in log if d == "P0" and m.kind == HAVE]
    assert sent and sent[-1].payload["v"] == 2
    assert "P0" not in px.bad_peers.get("a", set())
    px.on_piece_req(Msg(PIECE_REQ, "P0",
                        {"app_id": "a", "piece_id": 0, "v": 2}))
    assert any(m.kind == PIECE_DATA for _, m in log)


def test_stale_piece_data_discarded_without_ban():
    m1 = PieceManifest.synthetic("a", 8_000, 1_000, version=1)
    m2 = PieceManifest.synthetic("a", 8_000, 1_000, version=2,
                                 prev=m1, changed={0})
    px, log = _engine("L")
    px.join("a", m2)
    # piece 0 is the changed piece: its v1 proof is valid ONLY under v1 —
    # accepting it here is exactly the stale-as-fresh corruption the
    # version gate exists to stop
    px.on_piece_data(Msg(PIECE_DATA, "P0",
                         {"app_id": "a", "piece_id": 0, "v": 1,
                          "proof": m1.piece_hashes[0]}))
    assert px.stale_piece_data == 1 and px.stale_accepts == 0
    assert not px.inventories["a"].has(0)
    # not a ban: P0 is an honest v1 holder and stays usable once it
    # upgrades and re-announces under v2
    assert "P0" not in px.bad_peers.get("a", set())
    px.on_piece_data(Msg(PIECE_DATA, "P0",
                         {"app_id": "a", "piece_id": 0, "v": 2,
                          "proof": m2.piece_hashes[0]}))
    assert px.inventories["a"].has(0) and px.stale_accepts == 0


def test_intern_refcount_bounds_buffers_across_upgrades(monkeypatch):
    from repro_torch.core import piece_exchange as pe
    monkeypatch.setattr(pe, "_IMAGE_INTERN_MAX", 2)
    px, log = _engine("S")
    img = bytes((i * 13 + 5) % 256 for i in range(8_192))
    m = PieceManifest.from_bytes("app", img, 1_024)
    px.add_local_app("app", m, image=img)
    base = pe.interned_image_count()
    for v in range(2, 7):                       # five successive upgrades
        img = bytes((b + 1) % 256 for b in img)
        m = PieceManifest.from_bytes("app", img, 1_024, version=v, prev=m)
        assert px.upgrade("app", m, image=img, full=True)
    # each upgrade released the superseded buffer's reference: the cache
    # holds the live revision plus at most the bounded LRU dedup tail —
    # NOT one buffer per revision ever published
    assert pe.interned_image_count() <= base + 1 + 2
    live = px._interned["app"]
    assert live == m.manifest_hash and pe._IMAGE_REFS[live] == 1
    px.drop_app("app")
    assert "app" not in px._interned
    assert live not in pe._IMAGE_REFS
