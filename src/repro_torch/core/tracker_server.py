"""Tracking server (paper §III.C-E, Fig. 2; §V swarm extension).

Three modules:
  * connection module  — procedures PING, PUSH, RECV
  * tracker module     — procedures VAL, INIT, INFO
  * synchronizer       — procedures WRITE, READ

The server holds ONLY the applications list (AppInfo rows) and the member
set; application payloads never transit it — that is the point of the
paper's torrent-like design, and why the same server scales as the
framework's multi-pod job coordinator (cluster/coordinator.py).

Liveness (§III.D): a host's rows survive only while the host keeps updating
within `t` seconds, for at most `f` missed checks; after that the rows are
dropped and a DROP_APP notice fans out so leechers STOP dependent work.

The §V extension makes the server a real torrent tracker: each row carries
the full *seeder set* (every volunteer holding a validated copy of the app
image), ordered least-loaded-first from STATUS-reported lease counts so new
leechers are routed to the least-loaded seeder.  When a host dies but
replica seeders remain, the row is not dropped — the least-loaded live
replica is promoted to host and the application survives.  Volunteer exits
(BYE or missed pings) additionally fan out PEER_GONE so seeders reclaim the
leaver's leases immediately instead of waiting for TAIL timeouts.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set

from repro_torch.core.messages import (APP_LIST, BYE, COST_MAP, DROP_APP, HAVE,
                                 MANIFEST_UPDATE, PEER_GONE, PING, PONG,
                                 REGISTER, SEEDER_UPDATE, STATUS, AppInfo,
                                 Msg)
from repro_torch.core.runtime import Node, Runtime
from repro_torch.core.workunit import mask_nbytes


@dataclass
class TrackerConfig:
    ping_interval_s: float = 2.0        # t
    max_missed: int = 3                 # f
    push_interval_s: float = 1.0        # INIT's refresh timer
    blocked: tuple = ()                 # RECV blocklist parameter


class TrackerServer(Node):
    def __init__(self, node_id: str = "server",
                 config: Optional[TrackerConfig] = None,
                 val_hook: Optional[Callable[[str, Msg], bool]] = None,
                 topology=None):
        self.node_id = node_id
        self.cfg = config or TrackerConfig()
        self.val_hook = val_hook            # VAL customisation point (§III.G)
        # ALTO server role (P4P): when a core.topology.Topology is set,
        # every REGISTER is answered with a COST_MAP carrying the
        # registrant's island, its endpoint-cost row, and the node ->
        # island directory that peer selection ranks holders with
        self.topology = topology
        # synchronizer state
        self.app_list: Dict[str, AppInfo] = {}
        self.members: Set[str] = set()
        self.missed: Dict[str, int] = {}
        self.blocklist: Set[str] = set(self.cfg.blocked)
        self._init_cache: List[AppInfo] = []
        self._init_cache_at: float = -1e9
        self.log: List[tuple] = []
        # per-member boot nonce from REGISTER: a changed nonce means a
        # fresh process incarnation whose stale seeder claims must drop
        self.boot: Dict[str, float] = {}
        # per-app seeder load (active lease counts) from STATUS reports
        self.seeder_load: Dict[str, Dict[str, int]] = {}
        # per-app swarm membership (volunteers announcing via HAVE)
        self.swarms: Dict[str, Set[str]] = {}
        # cached per-app HAVE-relay fan-out (sorted, for determinism):
        # rebuilt only when membership or the seeder set changes, instead
        # of re-deriving an O(N) target set for every announce relayed
        self._relay_cache: Dict[str, tuple] = {}
        self._last_push: float = -1e9

    # ------------------------------------------------------------------ #
    def start(self, rt: Runtime) -> None:
        super().start(rt)
        rt.set_timer(self.node_id, "ping", self.cfg.ping_interval_s,
                     periodic=True)

    # ======================= connection module ========================= #
    def PING(self) -> None:
        """Availability check with (t, f) semantics (§III.D, §III.G)."""
        now = self.rt.now()
        for member in list(self.members):
            self.missed[member] = self.missed.get(member, 0) + 1
            self.rt.send(member, Msg(PING, self.node_id,
                                     {"at": now}, size_bytes=64))
            if self.missed[member] > self.cfg.max_missed:
                self.VAL(member, None, alive=False)

    def PUSH(self, dst: Optional[str] = None) -> None:
        """Send the applications list to one volunteer (or broadcast)."""
        rows = self.READ()
        if dst is None:
            self._last_push = self.rt.now()
        targets = [dst] if dst else list(self.members)
        for t in targets:
            self.rt.send(t, Msg(APP_LIST, self.node_id,
                                {"apps": rows},
                                size_bytes=256 + 64 * len(rows)))

    def RECV(self, msg: Msg) -> None:
        """Collect volunteer messages; honours the blocklist parameter."""
        if msg.src in self.blocklist:
            return
        self.log.append((self.rt.now(), msg.kind, msg.src))
        if msg.kind == PONG:
            self.missed[msg.src] = 0
        elif msg.kind == REGISTER:
            self.members.add(msg.src)
            self.missed[msg.src] = 0
            boot = msg.payload.get("boot")
            if boot is not None:
                prev = self.boot.get(msg.src)
                self.boot[msg.src] = boot
                if prev is not None and boot != prev:
                    # a NEW incarnation of a known node id: it crashed and
                    # restarted inside the liveness window, so its old
                    # seeder entries are claims about an image it no
                    # longer holds — drop them; a live replica re-earns
                    # its place via SEEDER_UPDATE once it re-verifies
                    self._drop_stale_seeder(msg.src)
            self.VAL(msg.src, msg, alive=True)
            self.INIT(msg.src)
            if self.topology is not None:
                isl = self.topology.island_of(msg.src)
                self.rt.send(msg.src, Msg(
                    COST_MAP, self.node_id,
                    {"island": isl,
                     "costs": self.topology.cost_row(isl),
                     "islands": dict(self.topology.islands)},
                    size_bytes=64 + 4 * len(self.topology.islands)))
        elif msg.kind == STATUS:
            # a STATUS from a volunteer we dropped (e.g. a ping false
            # positive under congestion) re-admits it
            self.members.add(msg.src)
            self.VAL(msg.src, msg, alive=True)
            for app_id, n in msg.payload.get("loads", {}).items():
                self.seeder_load.setdefault(app_id, {})[msg.src] = n
        elif msg.kind == SEEDER_UPDATE:
            self._on_seeder_update(msg)
        elif msg.kind == MANIFEST_UPDATE:
            self._on_manifest_update(msg)
        elif msg.kind == HAVE:
            self._on_have(msg)
        elif msg.kind == BYE:
            self.VAL(msg.src, msg, alive=False)

    # ========================= tracker module ========================== #
    def VAL(self, member: str, msg: Optional[Msg], alive: bool) -> None:
        """Validate host availability/updates; calls INFO on changes.

        Can be customised with `val_hook` (e.g. blacklist low-availability
        clients, §III.G)."""
        if self.val_hook is not None and msg is not None:
            if not self.val_hook(member, msg):
                self.blocklist.add(member)
                alive = False
        if not alive:
            self.INFO("drop_host", member)
            return
        self.missed[member] = 0
        if msg is not None and msg.kind in (REGISTER, STATUS):
            for row in msg.payload.get("apps", []):
                self.INFO("upsert", row)

    def INIT(self, member: str) -> None:
        """Push an initial applications list to a new volunteer.  Keeps a
        periodically refreshed cache (§III.G)."""
        now = self.rt.now()
        if now - self._init_cache_at > self.cfg.push_interval_s:
            self._init_cache = self.READ()
            self._init_cache_at = now
        self.rt.send(member, Msg(APP_LIST, self.node_id,
                                 {"apps": list(self._init_cache)},
                                 size_bytes=256 + 64 * len(self._init_cache)))

    def _on_have(self, msg: Msg) -> None:
        """Swarm announce: volunteers report verified pieces as a compact
        bitmask (or join with an empty one); the tracker relays so peers
        discover each other — its classic BitTorrent announce role."""
        app_id = msg.payload["app_id"]
        mask = msg.payload.get("mask", 0)
        swarm = self.swarms.setdefault(app_id, set())
        if msg.src not in swarm:
            swarm.add(msg.src)
            self._relay_cache.pop(app_id, None)
        targets = self._relay_cache.get(app_id)
        if targets is None:
            t = set(swarm)
            row = self.app_list.get(app_id)
            if row is not None:
                t |= set(row.seeders) | {row.host_id}
            t.discard(self.node_id)
            targets = self._relay_cache[app_id] = tuple(sorted(t))
        relay = Msg(HAVE, self.node_id,
                    {"app_id": app_id, "mask": mask, "peer": msg.src},
                    size_bytes=96 + mask_nbytes(mask))
        for t in targets:
            if t != msg.src:
                self.rt.send(t, relay)

    def _on_seeder_update(self, msg: Msg) -> None:
        """A volunteer finished (and verified) an app image: add it to the
        seeder set and let the existing seeders sync it up."""
        app_id = msg.payload["app_id"]
        seeder = msg.payload["seeder"]
        row = self.app_list.get(app_id)
        if row is None or seeder in self.blocklist:
            return
        mh = msg.payload.get("manifest_hash")
        if (mh is not None and row.manifest is not None
                and mh != row.manifest.manifest_hash):
            # the announce proves completion of a SUPERSEDED revision
            # (e.g. it raced a MANIFEST_UPDATE): admitting it would route
            # leechers to a node serving stale pieces as fresh
            return
        if seeder not in self.members:
            # a SEEDER_UPDATE from a node we already declared dead (e.g.
            # one that completed the image just before crashing, its
            # announce surviving in flight) must not enter the seeder set:
            # promoting a corpse to host would strand the app.  A live
            # sender re-announces after its next APP_LIST.
            return
        if seeder not in row.seeders:
            row.seeders = tuple(row.seeders) + (seeder,)
            row.updated_at = self.rt.now()
            self._relay_cache.pop(app_id, None)
            relay = Msg(SEEDER_UPDATE, self.node_id,
                        {"app_id": app_id, "seeder": seeder}, size_bytes=96)
            for peer in set(row.seeders) | {row.host_id}:
                if peer not in (seeder, self.node_id):
                    self.rt.send(peer, relay)
            # broadcast at most once per push interval: when a whole swarm
            # turns replica in a burst, one PUSH per completion is an
            # O(N²) APP_LIST storm; the periodic ping-time PUSH (and the
            # SEEDER_UPDATE relay above) still propagates the change
            if self.rt.now() - self._last_push >= self.cfg.push_interval_s:
                self.PUSH()

    def _on_manifest_update(self, msg: Msg) -> None:
        """The host published a new revision of an app image (versioned
        PieceManifest).  The seeder set is RESET to the publisher — every
        other entry describes the superseded revision — and the new
        metainfo is gossiped to the swarm immediately.  This path
        deliberately bypasses the SEEDER_UPDATE push limiter: version
        gossip that waits on `push_interval_s` leaves volunteers serving
        (and accepting) stale pieces as fresh."""
        app_id = msg.payload["app_id"]
        manifest = msg.payload.get("manifest")
        row = self.app_list.get(app_id)
        if row is None or manifest is None:
            return
        if msg.src != row.host_id:
            return                  # only the host may publish revisions
        if row.manifest is not None and not manifest.supersedes(row.manifest):
            return
        targets = set(self.swarms.get(app_id, ())) | set(row.seeders)
        targets.discard(msg.src)
        targets.discard(self.node_id)
        row.manifest = manifest
        row.seeders = (row.host_id,)
        row.updated_at = self.rt.now()
        self._relay_cache.pop(app_id, None)
        relay = Msg(MANIFEST_UPDATE, self.node_id,
                    {"app_id": app_id, "manifest": manifest},
                    size_bytes=512)
        for t in sorted(targets):
            self.rt.send(t, relay)
        # immediate broadcast, deliberately NOT gated on `_last_push`
        self.PUSH()

    def _drop_stale_seeder(self, member: str) -> None:
        """Remove `member` from every seeder set it does not host: its
        fresh incarnation lost the images backing those entries.  Rows it
        hosts are re-upserted by the REGISTER being processed."""
        for row in self.app_list.values():
            if member in row.seeders and row.host_id != member:
                row.seeders = tuple(s for s in row.seeders if s != member)
                self._relay_cache.pop(row.app_id, None)
        for swarm in self.swarms.values():
            swarm.discard(member)

    def _fail_hosts(self):
        """Re-elect a host for every row whose host is not a live member:
        promote the least-loaded live replica seeder, or mark the row for
        dropping when none is left.  Returns (dropped, promoted) rows —
        the caller sends the notifications (DROP_APP / PUSH) so message
        order stays under its control."""
        dropped, promoted = [], []
        for row in list(self.app_list.values()):
            if row.host_id in self.members:
                continue
            live = [s for s in row.seeders if s in self.members]
            if live:
                # replica failover: promote the least-loaded live
                # seeder instead of killing the application
                load = self.seeder_load.get(row.app_id, {})
                row.host_id = min(live,
                                  key=lambda s: (load.get(s, 0), s))
                row.updated_at = self.rt.now()
                promoted.append(row)
            else:
                dropped.append(row)
        for row in dropped:
            del self.app_list[row.app_id]
        return dropped, promoted

    def _reverify_rows(self) -> None:
        """Periodic re-verification (chaos hardening): prune seeders that
        are no longer live members from every row, and re-elect hosts for
        rows whose host died silently.  In a fault-free run this is a
        cheap no-op scan — the drop_host path keeps rows consistent — but
        under partitions/loss a row can go stale (e.g. a seeder announce
        that raced its sender's death), and a stale host would strand the
        app's leechers forever."""
        for row in self.app_list.values():
            live = tuple(s for s in row.seeders if s in self.members)
            if live != row.seeders:
                row.seeders = live
                self._relay_cache.pop(row.app_id, None)
        dropped, promoted = self._fail_hosts()
        if dropped:
            note = Msg(DROP_APP, self.node_id,
                       {"app_ids": [r.app_id for r in dropped]},
                       size_bytes=128)
            for m in self.members:
                self.rt.send(m, note)
        if promoted:
            self.PUSH()

    def INFO(self, change: str, data) -> None:
        """Forward availability/update changes to the synchronizer."""
        if change == "upsert":
            self.WRITE(data)
        elif change == "drop_host":
            member = data
            self.members.discard(member)
            self.missed.pop(member, None)
            self.boot.pop(member, None)
            self._relay_cache.clear()   # membership + seeder sets change
            for loads in self.seeder_load.values():
                loads.pop(member, None)
            for swarm in self.swarms.values():
                swarm.discard(member)
            for row in self.app_list.values():
                if member in row.seeders:
                    row.seeders = tuple(s for s in row.seeders
                                        if s != member)
            dropped, promoted = self._fail_hosts()
            if dropped:
                note = Msg(DROP_APP, self.node_id,
                           {"app_ids": [r.app_id for r in dropped]},
                           size_bytes=128)
                for m in self.members:
                    self.rt.send(m, note)
            # leavers' leases are reclaimed immediately at every seeder
            gone = Msg(PEER_GONE, self.node_id, {"node": member},
                       size_bytes=64)
            for m in self.members:
                self.rt.send(m, gone)
            if promoted:
                self.PUSH()

    # ======================= synchronizer module ======================= #
    def WRITE(self, row: AppInfo) -> None:
        row.updated_at = self.rt.now()
        self._relay_cache.pop(row.app_id, None)   # seeder set may change
        prev = self.app_list.get(row.app_id)
        if prev is not None:
            pv = getattr(prev.manifest, "version", None)
            rv = getattr(row.manifest, "version", None)
            if row.manifest is None or (pv is not None and rv is not None
                                        and pv > rv):
                # a stale upsert (e.g. a STATUS that raced an upgrade)
                # must never roll the metainfo back to a superseded
                # revision
                row.manifest = prev.manifest
                rv = pv
            if pv is not None and rv is not None and rv > pv:
                # the host republished via a plain upsert: every previous
                # seeder holds the superseded revision — reset the set
                row.seeders = (row.host_id,)
            else:
                # the seeder set is tracker-owned state: merge, don't
                # clobber
                merged = set(prev.seeders) | set(row.seeders) | {row.host_id}
                row.seeders = tuple(s for s in sorted(merged)
                                    if s == row.host_id or s in self.members)
        elif row.host_id not in row.seeders:
            row.seeders = tuple(row.seeders) + (row.host_id,)
        self.app_list[row.app_id] = row

    def READ(self) -> List[AppInfo]:
        rows = list(self.app_list.values())
        for row in rows:
            load = self.seeder_load.get(row.app_id, {})
            row.seeders = tuple(sorted(
                row.seeders, key=lambda s: (load.get(s, 0), s)))
        return rows

    # ------------------------------------------------------------------ #
    def on_message(self, msg: Msg) -> None:
        self.RECV(msg)

    def on_timer(self, name: str) -> None:
        if name == "ping":
            self.PING()
            self._reverify_rows()
            self.PUSH()
