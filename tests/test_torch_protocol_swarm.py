"""Piece-wise multi-seeder distribution through the live protocol (§V).

The reference's `tests/test_swarm_protocol.py`, run on
`repro_torch.core` on the CPU."""
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.protocol

from repro_torch.core import (Agent, AgentConfig, PieceInventory,
                              PieceManifest, SimRuntime, TrackerConfig,
                              TrackerServer, make_prime_app,
                              register_executable, resolve_executable)
from repro_torch.core.runtime import LinkModel
from repro_torch.core.swarm import rarest_first_order


# ----------------------- manifest / inventory unit --------------------- #
def test_piece_manifest_synthetic_and_sizes():
    m = PieceManifest.synthetic("a", total_bytes=10_000, piece_bytes=4096)
    assert m.n_pieces == 3
    assert m.piece_size(0) == 4096
    assert m.piece_size(2) == 10_000 - 2 * 4096
    assert len(set(m.piece_hashes)) == 3
    # identical params -> identical info hash; different app -> different
    assert m.manifest_hash == PieceManifest.synthetic(
        "a", 10_000, 4096).manifest_hash
    assert m.manifest_hash != PieceManifest.synthetic(
        "b", 10_000, 4096).manifest_hash


def test_piece_manifest_from_bytes_verifies():
    data = bytes(range(256)) * 40
    m = PieceManifest.from_bytes("x", data, piece_bytes=1024)
    inv = PieceInventory(m)
    assert not inv.complete
    # content-hashed manifest: the hashes are public metainfo, so a bare
    # proof (even the correct one) proves nothing — bytes are required
    assert m.content_hashed
    assert not inv.add(0, m.piece_hashes[0])
    assert not inv.add(1, "bogus-proof")
    # real byte slices verify by content re-hash; bogus bytes rejected
    assert inv.add(1, data=data[1024:2048])
    assert not inv.add(2, data=b"evil" * 256)
    assert 2 in inv.missing()
    for i in inv.missing():
        assert inv.add(i, data=data[i * 1024:(i + 1) * 1024])
    assert inv.complete
    assert inv.bitfield() == (1 << m.n_pieces) - 1   # compact int bitmask
    # synthetic manifests keep the proof path (simulation)
    s = PieceManifest.synthetic("x", 4096, 1024)
    assert not s.content_hashed
    assert PieceInventory(s).add(0, s.piece_hashes[0])


def test_rarest_first_order_policy():
    order = rarest_first_order([0, 1, 2, 3], {0: 5, 1: 1, 2: 3, 3: 1})
    assert order[:2] == [1, 3]           # rarest first
    assert order[-1] == 0                # most common last
    # offset staggers only tie-breaks
    shifted = rarest_first_order([0, 1, 2, 3], {0: 5, 1: 1, 2: 3, 3: 1},
                                 offset=2)
    assert set(shifted[:2]) == {1, 3}


def test_executable_registry_keyed_by_manifest_hash():
    register_executable("h123", run_fn=lambda p: p * 2,
                        cost_fn=lambda p, s: 1.0)
    entry = resolve_executable("h123")
    assert entry is not None and entry.run_fn(4) == 8
    assert resolve_executable("nope") is None
    # the old back-door into the runtime's node table is gone
    assert not hasattr(Agent, "_resolve_app")


# --------------------------- live protocol ----------------------------- #
def build_swarm(n_leechers=4, parts=24, image_mb=8.0, n_pieces=8,
                uplink_mbps=100.0, timeout=120.0):
    image = int(image_mb * 1e6)
    rt = SimRuntime(link=LinkModel(uplink_Bps=uplink_mbps * 1e6 / 8))
    server = TrackerServer(config=TrackerConfig(ping_interval_s=2.0))
    rt.add_node(server)
    host = Agent("host", config=AgentConfig(work_timeout_s=timeout))
    rt.add_node(host)
    app = make_prime_app("app", "host", 3, 24_000, n_parts=parts,
                         sim_time_per_number=1e-4, swarm=True,
                         app_bytes=image, piece_bytes=image // n_pieces)
    host.host_app(app)
    leechers = []
    for i in range(n_leechers):
        a = Agent(f"L{i}", config=AgentConfig(work_timeout_s=timeout))
        rt.add_node(a)
        leechers.append(a)
    return rt, server, host, app, leechers


def test_swarm_app_completes_with_replica_seeders():
    rt, server, host, app, leechers = build_swarm()
    rt.run(until=3600, stop_when=lambda: app.done)
    assert app.done
    # every leecher fetched + verified the full image and became a replica
    for l in leechers:
        assert "app" in l.images
        assert "app" in l.replicas
        inv = l.inventories["app"]
        assert inv.complete
    # tracker advertises the full seeder set, not just the origin
    row = server.app_list["app"]
    assert set(row.seeders) == {"host"} | {l.node_id for l in leechers}
    # results really are primes
    r0 = app.parts[0].results[0][1]
    assert 3 in r0 and 4 not in r0 and 5 in r0


def test_swarm_reduces_origin_uplink_vs_monolithic():
    def origin_bytes(swarm):
        image = int(8e6)
        rt = SimRuntime(link=LinkModel(uplink_Bps=12.5e6))
        rt.add_node(TrackerServer(config=TrackerConfig(ping_interval_s=2.0)))
        host = Agent("host", config=AgentConfig(work_timeout_s=600.0))
        rt.add_node(host)
        app = make_prime_app("app", "host", 3, 24_000, n_parts=24,
                             sim_time_per_number=1e-4, swarm=swarm,
                             app_bytes=image, piece_bytes=image // 8)
        host.host_app(app)
        for i in range(4):
            rt.add_node(Agent(f"L{i}",
                              config=AgentConfig(work_timeout_s=600.0)))
        rt.run(until=3600 * 4, stop_when=lambda: app.done)
        assert app.done
        return rt.tx_bytes.get("host", 0), rt.now()

    mono_bytes, mono_t = origin_bytes(swarm=False)
    swarm_bytes, swarm_t = origin_bytes(swarm=True)
    # the monolithic host re-ships the image per part; the swarm ships it
    # roughly once plus piece/protocol overheads
    assert swarm_bytes < mono_bytes / 4
    assert swarm_t <= mono_t


def test_origin_death_failover_to_replicas():
    rt, server, host, app, leechers = build_swarm(n_leechers=4, parts=30)
    # wait until at least one replica seeder formed
    rt.run(until=3600, stop_when=lambda: any(
        "app" in l.replicas for l in leechers))
    assert any("app" in l.replicas for l in leechers)
    del rt.nodes["host"]                 # origin dies mid-run
    rt.run(until=3600 * 4, stop_when=lambda: any(
        a.apps.get("app") and a.apps["app"].done for a in leechers))
    # the tracker promoted a replica instead of dropping the app …
    row = server.app_list.get("app")
    assert row is not None and row.host_id != "host"
    assert "host" not in row.seeders
    # … and the application completed under the new host
    promoted = [a for a in leechers if "app" in a.apps]
    assert promoted and promoted[0].apps["app"].done
    # leechers never STOPped the app
    assert all("app" not in l.stopped_apps for l in leechers)


def test_monolithic_app_still_dropped_on_host_death():
    # no replicas (swarm off): seed semantics preserved — host death kills
    rt = SimRuntime()
    server = TrackerServer(config=TrackerConfig(ping_interval_s=2.0))
    rt.add_node(server)
    host = Agent("host", config=AgentConfig(work_timeout_s=200.0))
    rt.add_node(host)
    app = make_prime_app("app", "host", 3, 500_000, n_parts=400,
                         sim_time_per_number=1e-4)
    host.host_app(app)
    leechers = [Agent(f"L{i}", config=AgentConfig(work_timeout_s=200.0))
                for i in range(2)]
    for a in leechers:
        rt.add_node(a)
    rt.run(until=20)
    del rt.nodes["host"]
    rt.run(until=rt.now() + 60)
    assert "app" not in server.app_list
    assert all("app" in l.stopped_apps for l in leechers)


def test_corrupt_piece_peer_is_ignored():
    rt, server, host, app, leechers = build_swarm(n_leechers=3)
    evil = leechers[0]

    def corrupt(msg):
        # serve garbage proofs for everything we hold
        from repro_torch.core.messages import PIECE_DATA, Msg
        app_id = msg.payload["app_id"]
        piece_id = msg.payload["piece_id"]
        evil.swarm_peers[app_id].add(msg.src)
        evil.SEND(msg.src, Msg(PIECE_DATA, evil.node_id,
                               {"app_id": app_id, "piece_id": piece_id,
                                "proof": "garbage",
                                "mask": evil._our_bitfield(app_id)},
                               size_bytes=96))
    evil._on_piece_req = corrupt
    rt.run(until=3600, stop_when=lambda: app.done)
    assert app.done
    # honest leechers verified every piece against the manifest
    for l in leechers[1:]:
        inv = l.inventories["app"]
        assert inv.complete
        for pid in inv.have:
            assert l.manifests["app"].piece_hashes[pid] \
                == inv.manifest.piece_hashes[pid]


def test_tracker_orders_seeders_by_load():
    server = TrackerServer()

    class _RT:
        def now(self):
            return 0.0
    server.rt = _RT()
    from repro_torch.core.messages import AppInfo
    row = AppInfo("a", "h", seeders=("s1", "s2", "s3"))
    server.app_list["a"] = row
    server.seeder_load["a"] = {"s1": 9, "s2": 0, "s3": 4}
    rows = server.READ()
    assert rows[0].seeders == ("s2", "s3", "s1")


def test_uplink_contention_serializes_bulk_only():
    from repro_torch.core.messages import Msg
    from repro_torch.core.runtime import Node

    got = []

    class Sink(Node):
        node_id = "sink"

        def on_message(self, msg):
            got.append((msg.payload["i"], self.rt.now()))

    link = LinkModel(uplink_Bps=1e6, base_latency_s=0.0,
                     bulk_threshold_bytes=1 << 16)
    rt = SimRuntime(link=link)
    rt.add_node(Sink())
    # two 1MB bulk sends from the same node serialise: ~1s and ~2s
    rt.send("sink", Msg("X", "src", {"i": 0}, size_bytes=1_000_000))
    rt.send("sink", Msg("X", "src", {"i": 1}, size_bytes=1_000_000))
    # a tiny control message bypasses the queue
    rt.send("sink", Msg("X", "src", {"i": 2}, size_bytes=64))
    rt.run()
    at = dict(got)
    assert at[0] == pytest.approx(1.0, rel=0.01)
    assert at[1] == pytest.approx(2.0, rel=0.01)
    assert at[2] < 0.1
    assert rt.tx_bytes["src"] == 2_000_064


# -------------- versioned manifests: tracker-side guards ---------------- #
def _tracker(members):
    server = TrackerServer()

    class _RT:
        def now(self):
            return 0.0

        def send(self, dst, msg):
            pass
    server.rt = _RT()
    server.members = set(members)
    return server


def test_tracker_write_never_rolls_back_manifest_revision():
    from repro_torch.core.messages import AppInfo
    server = _tracker({"h", "s1"})
    m1 = PieceManifest.synthetic("a", 8_000, 1_000)
    m2 = PieceManifest.synthetic("a", 8_000, 1_000, version=2, prev=m1)
    server.WRITE(AppInfo("a", "h", seeders=("h",), manifest=m2))
    server.app_list["a"].seeders = ("h", "s1")
    # a stale upsert (a STATUS that raced the upgrade) carries v1: the
    # row keeps the v2 metainfo and the merged seeder set
    server.WRITE(AppInfo("a", "h", seeders=("h",), manifest=m1))
    row = server.app_list["a"]
    assert row.manifest is m2
    assert set(row.seeders) == {"h", "s1"}
    # the host republishing a NEWER revision via plain upsert resets the
    # seeder set — everyone else holds the superseded image
    m3 = PieceManifest.synthetic("a", 8_000, 1_000, version=3, prev=m2)
    server.WRITE(AppInfo("a", "h", seeders=("h",), manifest=m3))
    row = server.app_list["a"]
    assert row.manifest is m3 and row.seeders == ("h",)


def test_tracker_rejects_stale_revision_completion():
    from repro_torch.core.messages import AppInfo, Msg, SEEDER_UPDATE
    server = _tracker({"h", "v1"})
    m1 = PieceManifest.synthetic("a", 8_000, 1_000)
    m2 = PieceManifest.synthetic("a", 8_000, 1_000, version=2, prev=m1)
    server.app_list["a"] = AppInfo("a", "h", seeders=("h",), manifest=m2)
    # v1 finished the OLD image just as the upgrade landed: admitting it
    # would route leechers to a node serving superseded pieces
    server.RECV(Msg(SEEDER_UPDATE, "v1",
                    {"app_id": "a", "seeder": "v1",
                     "manifest_hash": m1.manifest_hash}))
    assert server.app_list["a"].seeders == ("h",)
    # the same volunteer completing the CURRENT revision is admitted
    server.RECV(Msg(SEEDER_UPDATE, "v1",
                    {"app_id": "a", "seeder": "v1",
                     "manifest_hash": m2.manifest_hash}))
    assert set(server.app_list["a"].seeders) == {"h", "v1"}
