"""Volunteer agent (paper §III.E-G, Figs. 3-5; §V swarm extension).

Modules: connector (RECV, SEND), tracker (EVAL, DIST, STAT, VAL, TAIL) and
worker (REQ, SCAN, RUN, TIME, COLLECT, SAVE, LOAD, STOP) — the paper's 15
agent procedures.  Every agent is simultaneously:

  * a SEEDER for its own applications (A_self): answers REQ with app+data,
    validates RESULTs by m_min-way majority voting, reports status via STAT;
  * a LEECHER for other hosts' applications: REQ -> SCAN+RUN -> TIME ->
    COLLECT+LOAD -> SEND result, in a loop until the host runs dry.

The §V extension ("broken to pieces like regular file sharing in torrent")
adds a third role when an application is published with `swarm=True`:

  * a PIECE PEER: the app image moves as hashed pieces (PIECE_REQ /
    PIECE_DATA), scheduled by the PieceExchange engine
    (core/piece_exchange.py): rarest-first selection from HAVE bitmask
    announcements, seeder-side choke scheduling (INTERESTED/CHOKE/UNCHOKE,
    fixed upload slots, optimistic unchoke) and endgame duplicate requests
    reconciled with PIECE_CANCEL.  Once the image completes, the agent
    resolves the executable from the registry keyed by the manifest hash
    (no back-door into the runtime's node table) and becomes a REPLICA
    SEEDER: it answers REQ/DIST and VALidates results for the app, keeps
    in sync with the other seeders via PART_DONE gossip (cancelling now-
    redundant leases with PART_CANCEL), and can be promoted to host by the
    tracker if the origin dies.

The dual Seed/ and Leech/ working directories (Fig. 3) are managed by
core.directory; TAIL's volunteer log lives under Seed/App/<id>/Data/Tracker
and TIME's under Leech/App/<id>/Data/Time, as in the paper.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set

from repro_torch.core import directory as dirs
from repro_torch.core.messages import (APP_DATA, APP_LIST, BYE, CHOKE, COST_MAP,
                                 DROP_APP, HAVE, INTERESTED, MANIFEST_UPDATE,
                                 NO_WORK, PART_CANCEL, PART_DONE, PEER_GONE,
                                 PIECE_CANCEL, PIECE_DATA, PIECE_REQ, PING,
                                 PONG, REGISTER, REQ, RESULT, RESULT_ACK,
                                 SEEDER_UPDATE, STATUS, UNCHOKE, AppInfo, Msg)
from repro_torch.core.metrics import AppMetrics
from repro_torch.core.piece_exchange import PieceExchange
from repro_torch.core.runtime import CANCELLED, Node, Runtime
from repro_torch.core.validation import majority_vote
from repro_torch.core.workunit import (Application, LeaseTable, Part,
                                 register_executable, resolve_executable)


@dataclass
class AgentConfig:
    work_timeout_s: float = 60.0        # TAIL timeout parameter
    status_interval_s: float = 1.0
    retry_s: float = 2.0                # back-off after NO_WORK from a host
    # per-cycle protocol/VM overhead in simulation (calibrated from the
    # paper's Scenario I: w_parallel 6.35s vs sequential-VM 5.51s)
    cycle_overhead_s: float = 0.0
    accept_from: tuple = ()             # RECV accept/deny parameter
    deny_from: tuple = ()
    max_parallel_apps: int = 2          # leech this many apps concurrently
    self_leech: bool = False            # hosts also crunch their own apps
    root_dir: Optional[str] = None      # enables on-disk Fig. 3 layout
    piece_pipeline: int = 4             # outstanding PIECE_REQs per app
    replica_seed: bool = True           # re-seed completed swarm images
    # --- PieceExchange choke scheduler / endgame ----------------------- #
    choke: bool = True                  # seeder-side upload-slot limiting
    upload_slots: int = 4               # unchoked peers per app
    rechoke_interval_s: float = 10.0    # periodic re-choke cadence
    optimistic_every: int = 3           # rotate optimistic slot every N
    endgame: bool = True                # dup requests + CANCEL reconcile
    endgame_dup: int = 3                # max concurrent holders per piece
    # rolling window for the rechoke ranking's byte-rate estimate: peers
    # are ranked by bytes moved in the last window, not lifetime totals
    rate_window_s: float = 20.0
    # --- fault recovery (chaos hardening, see docs "Fault model") ------ #
    # staleness threshold for the pending-PIECE_REQ sweep (a lost request
    # or reply is re-issued after this); None keeps the conservative
    # default of work_timeout_s, which sits above any legitimate bulk
    # queueing delay
    piece_timeout_s: Optional[float] = None
    # re-send REGISTER after this much tracker silence: a lost REGISTER
    # (or a membership drop while partitioned) otherwise leaves the agent
    # off the tracker's push list forever
    reregister_s: float = 30.0
    # periodic re-gossip of validated parts to the other seeders; repairs
    # lost PART_DONE messages so seeder done-sets re-converge.  None (the
    # default) disables it — chaos scenarios turn it on.
    gossip_interval_s: Optional[float] = None
    # fetch swarm images even when the app's work is already finished
    # (pure replication, BitTorrent-style seeding): lets a volunteer that
    # crash-restarted after completion still converge to a full replica
    replicate_completed: bool = False
    # stop registering as a replica *seeder* (SEEDER_UPDATE + scheduling
    # state) once the app already lists this many seeders.  None keeps
    # every completed volunteer a seeder; large-N benchmarks cap it so
    # per-seeder bookkeeping and gossip stay O(cap), not O(N).  Piece
    # serving is unaffected — completed nodes keep answering PIECE_REQs.
    max_replica_seeders: Optional[int] = None
    # restrict PIECE_REQs to these peers (scalar engine only): the
    # origin-only baseline of the checkpoint cold-start benchmarks, where
    # every replica pulls straight from the blob-store stand-in instead
    # of exchanging pieces.  () keeps normal swarm-wide selection.
    fetch_from: tuple = ()


class Agent(Node):
    def __init__(self, node_id: str, server_id: str = "server",
                 config: Optional[AgentConfig] = None,
                 val_hook: Optional[Callable[[int, Any], bool]] = None,
                 hub=None):
        self.node_id = node_id
        self.server_id = server_id
        self.cfg = config or AgentConfig()
        self.val_hook = val_hook
        # --- seeder state -------------------------------------------------
        self.apps: Dict[str, Application] = {}         # A_self
        self.replicas: Dict[str, Application] = {}     # re-seeded swarm apps
        self.tail = LeaseTable(self.cfg.work_timeout_s)
        self.tails: Dict[str, LeaseTable] = {}
        self.metrics: Dict[str, AppMetrics] = {}
        # --- leecher state ------------------------------------------------
        self.app_list: List[AppInfo] = []
        self.current: Dict[str, dict] = {}             # app_id -> work ctx
        self.results_log: List[tuple] = []
        self.part_results: Dict[tuple, Any] = {}       # (app, part) -> R
        # voters whose result for a part passed through this seeder (kept
        # even when the result is forwarded to the part's owner, so DIST
        # never re-grants a part to a volunteer that already voted)
        self.voted: Dict[tuple, Set[str]] = collections.defaultdict(set)
        self.completed_cycles: Dict[str, int] = collections.defaultdict(int)
        self.leech_time: Dict[str, float] = collections.defaultdict(float)
        self.leech_bytes: Dict[str, float] = collections.defaultdict(float)
        self.stopped_apps: Set[str] = set()
        # quorum size at the moment each part validated here (chaos
        # invariant: never more than m_min + 1 voters decide a part)
        self.quorum_sizes: Dict[tuple, int] = {}
        self._last_server = 0.0         # last message seen from the tracker
        self.dry_until: Dict[str, float] = {}
        self.completed_at: Dict[str, float] = {}
        # app_id -> sim time the full image verified here (Scenario IX's
        # per-node completion distribution; p99 comes from these)
        self.image_completed_at: Dict[str, float] = {}
        self.no_work_from: Dict[str, Set[str]] = collections.defaultdict(set)
        self.cancelled_parts = 0                # PART_CANCEL aborts
        self.dir = (dirs.AgentDirs(self.cfg.root_dir, node_id)
                    if self.cfg.root_dir else None)
        # --- piece-peer state (paper §V): the PieceExchange engine --------
        self.images: Dict[str, str] = {}        # app_id -> verified manifest
        self.px = PieceExchange(
            node_id, self.cfg, send=self.SEND, now=lambda: self.rt.now(),
            tracker_id=server_id, dirs=self.dir,
            on_image_complete=self._on_image_complete,
            on_bytes=self._on_piece_bytes, hub=hub)

    def _on_piece_bytes(self, app_id: str, nbytes: int) -> None:
        self.leech_bytes[app_id] += nbytes

    # engine views kept for tests/tools (the engine owns the state)
    @property
    def manifests(self):
        return self.px.manifests

    @property
    def inventories(self):
        return self.px.inventories

    @property
    def swarm_peers(self):
        return self.px.swarm_peers

    @property
    def full_seeders(self):
        return self.px.full_seeders

    # ------------------------------------------------------------------ #
    def host_app(self, app: Application) -> None:
        app.host_id = self.node_id
        manifest = app.ensure_manifest()
        # publishing an app puts its executable behind the manifest hash:
        # only holders of the verified image may resolve and run it
        register_executable(manifest.manifest_hash, app.run_fn, app.cost_fn,
                            blueprint=app.blueprint())
        self.apps[app.app_id] = app
        self.px.add_local_app(app.app_id, manifest, image=app.image)
        self.images[app.app_id] = manifest.manifest_hash
        self.tails[app.app_id] = LeaseTable(self.cfg.work_timeout_s)
        m = AppMetrics(d_app_bytes=app.app_bytes, m_min=app.m_min)
        self.metrics[app.app_id] = m
        if self.dir:
            self.dir.seed_app(app.app_id, app.app_bytes, image=app.image)

    def publish_update(self, app_id: str, new_manifest,
                       image: Optional[bytes] = None) -> bool:
        """Publish revision v(k+1) of a hosted app (delta distribution).

        Swaps the image behind a strictly newer versioned manifest,
        re-registers the executables under the new manifest hash, and
        announces MANIFEST_UPDATE to the tracker, which resets the seeder
        set to this host and gossips the new metainfo to the swarm —
        members then carry over unchanged verified pieces and fetch only
        the delta.  `image` carries the new bytes for real apps (synthetic
        revisions pass None).  Returns False for non-superseding updates."""
        app = self.apps.get(app_id)
        if app is None:
            return False
        old = app.manifest
        if old is not None and not new_manifest.supersedes(old):
            return False
        app.manifest = new_manifest
        if image is not None:
            app.image = image
            app.app_bytes = len(image)
        register_executable(new_manifest.manifest_hash, app.run_fn,
                            app.cost_fn, blueprint=app.blueprint())
        self.px.upgrade(app_id, new_manifest, image=app.image, full=True)
        self.images[app_id] = new_manifest.manifest_hash
        if self.dir:
            self.dir.seed_app(app_id, app.app_bytes, image=app.image)
        self.SEND(self.server_id, Msg(MANIFEST_UPDATE, self.node_id,
                                      {"app_id": app_id,
                                       "manifest": new_manifest},
                                      size_bytes=512))
        return True

    def start(self, rt: Runtime) -> None:
        super().start(rt)
        self._last_server = rt.now()
        # boot nonce: stable for this process incarnation, different after
        # a crash-restart — the tracker uses it to tell "same agent
        # re-registering" from "fresh process that lost its state" and
        # drops the stale seeder claims of the latter
        if not hasattr(self, "_boot"):
            self._boot = rt.now()
        self.SEND(self.server_id, Msg(REGISTER, self.node_id,
                                      {"apps": self._self_rows(),
                                       "boot": self._boot}))
        rt.set_timer(self.node_id, "status", self.cfg.status_interval_s,
                     periodic=True)
        rt.set_timer(self.node_id, "tail", self.cfg.work_timeout_s / 2,
                     periodic=True)
        if self.cfg.choke:
            rt.set_timer(self.node_id, "rechoke",
                         self.cfg.rechoke_interval_s, periodic=True)
        if self.cfg.gossip_interval_s:
            rt.set_timer(self.node_id, "gossip",
                         self.cfg.gossip_interval_s, periodic=True)

    def shutdown(self) -> None:
        """Graceful leave: BYE tells the server to reclaim this volunteer's
        leases immediately instead of waiting for TAIL timeouts."""
        self.SEND(self.server_id, Msg(BYE, self.node_id,
                                      {"apps": list(self.apps)},
                                      size_bytes=64))

    def _self_rows(self) -> List[AppInfo]:
        rows = []
        for app in self.apps.values():
            m = self.metrics[app.app_id]
            rows.append(AppInfo(app.app_id, self.node_id, d=m.d, p=m.p,
                                w=m.w, n_parts=len(app.parts),
                                parts_remaining=sum(
                                    0 if p.done else 1 for p in app.parts),
                                seeders=(self.node_id,),
                                manifest=(app.manifest if app.swarm
                                          else None)))
        return rows

    def _seed_loads(self) -> Dict[str, int]:
        """Per-app seeding pressure: active lease counts plus the choke
        scheduler's upload load (granted slots + queued piece requests);
        the tracker uses them for least-loaded routing."""
        loads = {}
        for app_id in list(self.apps) + list(self.replicas):
            tail = self.tails.get(app_id)
            if tail is not None:
                loads[app_id] = (sum(len(ls)
                                     for ls in tail.active().values())
                                 + self.px.seed_load(app_id))
        return loads

    # ========================== connector =============================== #
    def RECV(self, msg: Msg) -> None:
        """Receive messages; accept/deny lists are the paper's parameter."""
        if self.cfg.accept_from and msg.src not in self.cfg.accept_from \
                and msg.src != self.server_id:
            return
        if msg.src in self.cfg.deny_from:
            return
        if msg.src == self.server_id:
            self._last_server = self.rt.now()
        kind = msg.kind
        # swarm data-plane kinds first: HAVE announces alone are O(N) per
        # verified piece, so they dominate the dispatch at scale
        if kind == HAVE:
            self.px.on_have(msg)
        elif kind == PIECE_REQ:
            self._on_piece_req(msg)
        elif kind == PIECE_DATA:
            self.px.on_piece_data(msg)
        elif kind == INTERESTED:
            self.px.on_interested(msg)
        elif kind == CHOKE:
            self.px.on_choke(msg)
        elif kind == UNCHOKE:
            self.px.on_unchoke(msg)
        elif kind == PIECE_CANCEL:
            self.px.on_piece_cancel(msg)
        elif kind == PING:
            self.SEND(self.server_id, Msg(PONG, self.node_id, size_bytes=64))
        elif kind == APP_LIST:
            self._on_app_list(msg.payload["apps"])
        elif kind == DROP_APP:
            for app_id in msg.payload["app_ids"]:
                self.STOP(app_id, reason="host dropped from list")
        elif kind == REQ:
            self.DIST(msg.src, msg.payload["app_id"])
        elif kind == APP_DATA:
            self._on_app_data(msg)
        elif kind == NO_WORK:
            self._on_no_work(msg)
        elif kind == RESULT:
            self.VAL(msg)
        elif kind == RESULT_ACK:
            self._on_result_ack(msg)
        elif kind == PART_CANCEL:
            self._on_part_cancel(msg)
        elif kind == PART_DONE:
            self._on_part_done(msg)
        elif kind == PEER_GONE:
            self._on_peer_gone(msg.payload["node"])
        elif kind == SEEDER_UPDATE:
            self._on_seeder_update(msg)
        elif kind == MANIFEST_UPDATE:
            self._apply_manifest_update(msg.payload["app_id"],
                                        msg.payload["manifest"])
        elif kind == COST_MAP:
            self.px.set_cost_map(msg.payload["island"],
                                 msg.payload["costs"],
                                 msg.payload.get("islands"))

    def _on_piece_req(self, msg: Msg) -> None:
        # kept as a seam (tests stub a malicious serving path here); the
        # engine owns the real choke-aware serving logic
        self.px.on_piece_req(msg)

    def _our_bitfield(self, app_id: str) -> int:
        return self.px.bitfield_mask(app_id)

    def SEND(self, dst: str, msg: Msg) -> None:
        self.rt.send(dst, msg)

    # =========================== tracker ================================ #
    def EVAL(self, app_id: str, valid: bool) -> None:
        """Track m_min/m_max progress for an application's validation."""
        app = self.apps.get(app_id)
        if app is None:
            return
        if valid and app.m_min < app.m_max:
            app.m_min += 1
            self.metrics[app_id].m_min = app.m_min

    def _seeded_app(self, app_id: str) -> Optional[Application]:
        return self.apps.get(app_id) or self.replicas.get(app_id)

    def _seeder_ring(self, app_id: str) -> List[str]:
        row = self._row_for(app_id)
        return sorted(set(row.seeders if row else ()) | {self.node_id})

    def _part_owner(self, app_id: str, part_id: int) -> str:
        """The seeder responsible for a part: the owner of the partition
        DIST's grant scan assigns it to.  Results for the part converge
        there so the m_min quorum forms at one place even when endgame
        leases scatter across seeders."""
        seeders = self._seeder_ring(app_id)
        return seeders[part_id % len(seeders)]

    def DIST(self, volunteer: str, app_id: str) -> None:
        """Lease the next pending part to `volunteer` and ship app+data.

        The part space is split across the current seeder set so
        concurrent seeders rarely lease the same part; a seeder whose
        partition is drained falls back to any pending part (endgame)."""
        app = self._seeded_app(app_id)
        if app is None:
            self.SEND(volunteer, Msg(NO_WORK, self.node_id,
                                     {"app_id": app_id}, size_bytes=64))
            return
        tail = self.tails[app_id]
        leased = tail.by_part            # empty lists count as no lease
        seeders = self._seeder_ring(app_id) if app.swarm else []
        if len(seeders) > 1:
            s, me = len(seeders), seeders.index(self.node_id)

            def in_partition(p: Part) -> bool:
                return p.part_id % s == me
        else:
            def in_partition(p: Part) -> bool:
                return True
        voted = self.voted

        # skip parts this volunteer already contributed to (a result seen
        # or forwarded here, or an active lease): a quorum needs
        # *distinct* voters, and re-granting just burns a duplicate
        # execution or spins a cached-resend loop
        def acceptable(p: Part) -> bool:
            return (volunteer not in voted.get((app_id, p.part_id), ())
                    and not any(v == volunteer for v, _, _ in p.results)
                    and not any(l.volunteer_id == volunteer
                                for l in leased.get(p.part_id, ())))

        part = app.grant_candidate(leased, in_partition, acceptable)
        if part is None:
            self.SEND(volunteer, Msg(NO_WORK, self.node_id,
                                     {"app_id": app_id}, size_bytes=64))
            return
        tail.grant(part.part_id, volunteer, self.rt.now())
        if self.dir:
            self.dir.tracker_log(app_id,
                                 f"{self.rt.now():.3f} lease part="
                                 f"{part.part_id} to={volunteer}")
        manifest = app.manifest
        if app.swarm:
            # piece-wise mode: the image moved separately as pieces, so
            # APP_DATA carries only the part payload
            size = 96 + part.data_bytes
            app_bytes = 0
        else:
            size = app.app_bytes + part.data_bytes
            app_bytes = app.app_bytes
        self.SEND(volunteer, Msg(
            APP_DATA, self.node_id,
            {"app_id": app_id, "part_id": part.part_id,
             "payload": part.payload, "app_bytes": app_bytes,
             "data_bytes": part.data_bytes,
             "manifest_hash": (manifest.manifest_hash if manifest
                               else None)},
            size_bytes=size))

    def STAT(self) -> None:
        """Update validated-work status (incl. d, w) to the server."""
        self.SEND(self.server_id, Msg(STATUS, self.node_id,
                                      {"apps": self._self_rows(),
                                       "loads": self._seed_loads()}))

    def VAL(self, msg: Msg) -> None:
        """Validate a RESULT by majority voting once m_min results arrived.

        For swarm apps the quorum forms at the part's *owner* seeder:
        another seeder that leased the part in endgame fallback forwards
        the result there (ACKing its volunteer itself), so m_min is
        reached promptly instead of results scattering one-per-seeder and
        every seeder re-leasing the part."""
        app_id = msg.payload["app_id"]
        app = self._seeded_app(app_id)
        if app is None:
            return
        part_id = msg.payload["part_id"]
        part = app.parts[part_id]
        tail = self.tails[app_id]
        forwarded = msg.payload.get("forwarded", False)
        volunteer = msg.payload.get("volunteer", msg.src)
        tail.release(part_id, volunteer)
        if self.val_hook is not None and not self.val_hook(
                part_id, msg.payload["result"]):
            # malicious result: discard; status not updated (paper §III.D).
            # The rejected volunteer's vote is still *consumed* (recorded
            # in `voted`), so DIST never re-grants it the same part — a
            # cached resend would otherwise spin an unthrottled
            # grant->resend->reject loop
            self.voted[(app_id, part_id)].add(volunteer)
            # always tell the *volunteer* (the forwarder already ACKed it
            # optimistically): valid=False makes it drop its cached copy
            # so the bad result is not replayed to other seeders
            self.SEND(volunteer, Msg(RESULT_ACK, self.node_id,
                                     {"app_id": app_id,
                                      "part_id": part_id,
                                      "valid": False}, size_bytes=64))
            return
        self.voted[(app_id, part_id)].add(volunteer)
        if app.swarm and not forwarded and not part.done:
            # seeder ring views may diverge briefly while the tracker
            # propagates a new replica; a mis-routed forward is then
            # simply validated at the receiver (never re-forwarded), and
            # PART_DONE gossip re-converges the done sets
            owner = self._part_owner(app_id, part_id)
            if owner != self.node_id:
                self.SEND(owner, Msg(RESULT, self.node_id,
                                     {**msg.payload, "forwarded": True,
                                      "volunteer": volunteer},
                                     size_bytes=1024))
                self.SEND(volunteer, Msg(RESULT_ACK, self.node_id,
                                         {"app_id": app_id,
                                          "part_id": part_id,
                                          "valid": True}, size_bytes=64))
                return
        if any(v == volunteer for v, _, _ in part.results):
            # duplicate vote (e.g. a cached resend routed via another
            # seeder): m_min demands *distinct* voters
            if not forwarded:
                self.SEND(msg.src, Msg(RESULT_ACK, self.node_id,
                                       {"app_id": app_id,
                                        "part_id": part_id,
                                        "valid": True}, size_bytes=64))
            return
        part.results.append((volunteer, msg.payload["result"],
                             msg.payload.get("time_s", 0.0)))
        if len(part.results) >= app.m_min and not part.done:
            winner, ok = majority_vote([r for _, r, _ in part.results],
                                       quorum=app.m_min)
            if ok:
                part.done = True
                part.winner = winner
                self.quorum_sizes[(app_id, part_id)] = len(part.results)
                m = self.metrics.get(app_id)
                if m is not None:
                    m.record_cycle(
                        msg.payload.get("data_bytes", part.data_bytes),
                        msg.payload.get("time_s", 0.0),
                        app_downloaded=not app.swarm)
                self._cancel_part_leases(app_id, part_id)
                self.EVAL(app_id, True)
                if self.dir:
                    self.dir.save_seed_result(app_id, part_id, winner)
                if app.swarm:
                    self._gossip_part_done(app_id, [(part_id, winner)])
                if app.done and app_id not in self.completed_at:
                    self.completed_at[app_id] = self.rt.now()
                if app_id in self.apps:
                    self.STAT()
        if not forwarded:
            self.SEND(msg.src, Msg(RESULT_ACK, self.node_id,
                                   {"app_id": app_id, "part_id": part_id,
                                    "valid": True}, size_bytes=64))

    def TAIL(self) -> None:
        """Expire overdue leases and re-DIST (straggler mitigation)."""
        now = self.rt.now()
        for app_id, tail in self.tails.items():
            for lease in tail.expired(now):
                tail.release(lease.part_id, lease.volunteer_id)
                if self.dir:
                    self.dir.tracker_log(app_id,
                                         f"{now:.3f} timeout part="
                                         f"{lease.part_id} "
                                         f"volunteer={lease.volunteer_id}")
                # the paper drops the volunteer from the mapping list and
                # redistributes on the next REQ; nothing else to do here

    def _cancel_part_leases(self, app_id: str, part_id: int) -> None:
        """Endgame reconciliation for *work*: a part just validated, so any
        lease still outstanding for it (duplicate leasing happens when
        seeder partitions drain) is redundant — release it and PART_CANCEL
        the volunteer so the duplicate execution aborts."""
        if not self.cfg.endgame:
            return
        tail = self.tails.get(app_id)
        if tail is None:
            return
        for lease in list(tail.active().get(part_id, [])):
            tail.release(part_id, lease.volunteer_id)
            self.SEND(lease.volunteer_id,
                      Msg(PART_CANCEL, self.node_id,
                          {"app_id": app_id, "part_id": part_id},
                          size_bytes=64))

    def _on_part_cancel(self, msg: Msg) -> None:
        """The part this volunteer is crunching was validated elsewhere:
        abort the (now redundant) execution and move on to fresh work."""
        app_id = msg.payload["app_id"]
        part_id = msg.payload["part_id"]
        ctx = self.current.get(app_id)
        if ctx is None or not ctx.get("busy"):
            return
        tag = ctx.get("tag")
        if tag is None or tag[1] != part_id:
            return
        if self.rt.cancel_work(self.node_id, tag):
            # simulator path: the job is gone, continue leeching now
            self.cancelled_parts += 1
            ctx["busy"] = False
            ctx["tag"] = None
            self.TIME(app_id, "cancel")
            self._request_work(app_id)
        else:
            # real-time path: the result (or CANCELLED sentinel) still
            # arrives; mark it for discard in on_work_done
            ctx["drop"] = tag

    # ================== seeder-set sync (paper §V) ====================== #
    def _other_seeders(self, app_id: str) -> Set[str]:
        row = self._row_for(app_id)
        peers = set(row.seeders) | {row.host_id} if row else set()
        peers |= self.swarm_peers.get(app_id, set())
        peers.discard(self.node_id)
        return peers

    def _done_parts(self, app) -> List[tuple]:
        """(part_id, validated winner) for every done part — the payload
        PART_DONE syncs carry.  `winner` is the majority_vote result;
        falling back to the first recorded vote only covers parts from
        pre-`winner` state (e.g. a restore)."""
        return [(p.part_id, p.winner if p.winner is not None
                 else (p.results[0][1] if p.results else None))
                for p in app.parts if p.done]

    def _gossip_part_done(self, app_id: str,
                          parts: List[tuple]) -> None:
        for peer in self._other_seeders(app_id):
            self.SEND(peer, Msg(PART_DONE, self.node_id,
                                {"app_id": app_id, "parts": parts},
                                size_bytes=96 + 32 * len(parts)))

    def _on_part_done(self, msg: Msg) -> None:
        app = self._seeded_app(msg.payload["app_id"])
        if app is None:
            return
        app_id = msg.payload["app_id"]
        for part_id, winner in msg.payload["parts"]:
            part = app.parts[part_id]
            if not part.done:
                part.done = True
                part.winner = winner
                part.results.append((msg.src, winner, 0.0))
                # another seeder validated it first: any lease this seeder
                # still holds for the part is a duplicate — cancel it
                self._cancel_part_leases(app_id, part_id)
        if app.done and app_id not in self.completed_at:
            self.completed_at[app_id] = self.rt.now()

    def _on_seeder_update(self, msg: Msg) -> None:
        """Relayed by the tracker: a new replica joined the seeder set —
        bring it up to date on validated parts.  Only the app's host plus
        the three lowest-id seeders in this agent's current view send the
        sync: one copy suffices, and N existing seeders each shipping the
        full done list to every newcomer made replica formation
        O(N² · parts) in large swarms.  The host is always a sender
        because the tracker keeps `host_id` pointing at a live node
        (promotion pushes immediately), so even a stale seeder view
        cannot leave the newcomer without any sync."""
        app_id = msg.payload["app_id"]
        new_seeder = msg.payload["seeder"]
        app = self._seeded_app(app_id)
        if app is None or new_seeder == self.node_id:
            return
        self.swarm_peers[app_id].add(new_seeder)
        ring = [s for s in self._seeder_ring(app_id) if s != new_seeder]
        row = self._row_for(app_id)
        is_host = (app_id in self.apps
                   or (row is not None and row.host_id == self.node_id))
        if not is_host and self.node_id not in ring[:3]:
            return
        done = self._done_parts(app)
        if done:
            self.SEND(new_seeder, Msg(PART_DONE, self.node_id,
                                      {"app_id": app_id, "parts": done},
                                      size_bytes=96 + 32 * len(done)))

    def _on_peer_gone(self, node: str) -> None:
        """A volunteer left (BYE) or died: reclaim its leases immediately
        instead of waiting for TAIL timeout, and forget its pieces."""
        for app_id, tail in self.tails.items():
            freed = tail.drop_volunteer(node)
            if freed and self.dir:
                self.dir.tracker_log(app_id,
                                     f"{self.rt.now():.3f} peer_gone "
                                     f"volunteer={node} parts={freed}")
        # engine side: forget pieces/slots, re-route outstanding requests
        self.px.on_peer_gone(node)
        # re-route in-flight work pointed at the dead peer
        for app_id, ctx in list(self.current.items()):
            if ctx.get("host") == node and not ctx.get("busy"):
                self._request_work(app_id)

    # ==================== piece transfer (paper §V) ===================== #
    # All swarm transfer mechanics live in the PieceExchange engine
    # (core/piece_exchange.py); the agent only routes messages to it (see
    # RECV) and reacts to image completion below.
    def _apply_manifest_update(self, app_id: str, manifest) -> None:
        """A newer revision of an app we track was published (tracker
        MANIFEST_UPDATE gossip, or a fresher APP_LIST row): retire the
        old image identity and move the engine to the delta fetch.
        Idempotent; stale or duplicate updates are ignored."""
        if manifest is None or app_id in self.apps:
            return                       # we are the publisher (or junk)
        local = self.px.manifests.get(app_id)
        if local is None or not manifest.supersedes(local):
            return
        # the old manifest hash no longer names a valid image here: work
        # execution and replica seeding re-enable when v(k+1) verifies
        self.images.pop(app_id, None)
        self.image_completed_at.pop(app_id, None)
        if not self.px.upgrade(app_id, manifest):
            return
        if app_id in self.px.fetching:
            ctx = self.current.setdefault(app_id, {"host": None,
                                                   "busy": False})
            ctx["fetching"] = True
            ctx["last_req"] = self.rt.now()

    def _on_image_complete(self, app_id: str, manifest_hash: str,
                           image: Optional[bytes]) -> None:
        """Engine callback — all pieces verified: unpack the executable via
        the registry and join the seeder set as a replica."""
        self.images[app_id] = manifest_hash
        self.image_completed_at.setdefault(app_id, self.rt.now())
        entry = resolve_executable(manifest_hash)
        cap = self.cfg.max_replica_seeders
        if cap is not None:
            row = next((r for r in self.app_list if r.app_id == app_id),
                       None)
            if row is not None and len(row.seeders) >= cap:
                entry = None     # enough seeders already; serve pieces only
        if (self.cfg.replica_seed and entry is not None
                and entry.blueprint is not None
                and app_id not in self.apps
                and app_id not in self.replicas):
            app = entry.blueprint()
            self.replicas[app_id] = app
            self.tails.setdefault(app_id,
                                  LeaseTable(self.cfg.work_timeout_s))
            self.metrics.setdefault(app_id, AppMetrics(
                d_app_bytes=app.app_bytes, m_min=app.m_min))
            self.SEND(self.server_id, Msg(SEEDER_UPDATE, self.node_id,
                                          {"app_id": app_id,
                                           "seeder": self.node_id,
                                           "manifest_hash": manifest_hash},
                                          size_bytes=96))
        elif (self.cfg.replica_seed and entry is not None
                and app_id in self.replicas):
            # a revision upgrade completed while we were already a replica
            # seeder: the tracker reset the app's seeder set to the
            # publisher, so our membership must be re-announced
            self.replicas[app_id] = (entry.blueprint()
                                     if entry.blueprint is not None
                                     else self.replicas[app_id])
            self.SEND(self.server_id, Msg(SEEDER_UPDATE, self.node_id,
                                          {"app_id": app_id,
                                           "seeder": self.node_id,
                                           "manifest_hash": manifest_hash},
                                          size_bytes=96))
        ctx = self.current.get(app_id)
        if ctx is not None and ctx.get("fetching"):
            self._request_work(app_id)

    # ============================ worker ================================ #
    def REQ(self, app_id: str, host_id: str) -> None:
        """Request application + next data part from the host."""
        ctx = self.current.setdefault(app_id, {"host": host_id,
                                               "busy": False})
        ctx["host"] = host_id
        ctx["fetching"] = False
        ctx["awaiting"] = True          # a grant is in flight
        ctx["last_req"] = self.rt.now()
        self.SEND(host_id, Msg(REQ, self.node_id, {"app_id": app_id},
                               size_bytes=96))

    def SCAN(self, payload: dict) -> int:
        """Measure the size of the received application and data."""
        return int(payload.get("app_bytes", 0)) + int(
            payload.get("data_bytes", 0))

    def RUN(self, app_id: str, part_id: int, payload: Any,
            host_id: str) -> None:
        """Execute one part; TIME marks start/end via the runtime."""
        ctx = self.current.get(app_id)
        if ctx is None or ctx.get("busy"):
            return      # stale APP_DATA must not double-submit work
        ctx["busy"] = True
        sim_dur = None
        fn = None
        # resolve the executable from the registry, keyed by the manifest
        # hash of the (verified) image this agent holds
        mh = self.images.get(app_id)
        entry = resolve_executable(mh) if mh else None
        if entry is not None:
            if entry.cost_fn is not None:
                # work units at reference speed 1.0; the runtime's processor-
                # sharing executor applies node speed and contention
                sim_dur = entry.cost_fn(payload, 1.0) \
                    + self.cfg.cycle_overhead_s
            if entry.run_fn is not None:
                fn = (lambda p=payload, f=entry.run_fn: f(p))
        tag = (app_id, part_id, host_id)
        ctx["tag"] = tag                # PART_CANCEL needs the exact tag
        self.TIME(app_id, "start")
        self.rt.submit_work(self.node_id, tag, fn, sim_duration_s=sim_dur)

    def TIME(self, app_id: str, mark: str) -> None:
        """Track working time; log kept under Leech/App/Data/Time (Fig. 3)."""
        if self.dir:
            self.dir.time_log(app_id, f"{self.rt.now():.3f} {mark}")

    def COLLECT(self, app_id: str, elapsed_s: float, nbytes: int) -> dict:
        """Gather TIME and SCAN info about a finished part."""
        self.leech_time[app_id] += elapsed_s
        self.leech_bytes[app_id] += nbytes
        self.completed_cycles[app_id] += 1
        return {"time_s": elapsed_s, "data_bytes": nbytes}

    def SAVE(self, app_id: str, part_id: int, result: Any) -> None:
        if self.dir:
            self.dir.save_leech_result(app_id, part_id, result)

    def LOAD(self, app_id: str, part_id: int) -> Any:
        if self.dir:
            return self.dir.load_leech_result(app_id, part_id)
        return None

    def STOP(self, app_id: str, reason: str = "") -> None:
        """Drop an application: its data, results and pending work."""
        self.current.pop(app_id, None)
        self.stopped_apps.add(app_id)
        self.app_list = [a for a in self.app_list if a.app_id != app_id]
        self.replicas.pop(app_id, None)
        keep_image = app_id in self.apps
        if not keep_image:
            self.images.pop(app_id, None)
        self.px.drop_app(app_id, keep_image=keep_image)
        self.no_work_from.pop(app_id, None)
        for key in [k for k in self.part_results if k[0] == app_id]:
            del self.part_results[key]
        for key in [k for k in self.voted if k[0] == app_id]:
            del self.voted[key]
        if self.dir:
            self.dir.drop_leech_app(app_id)
        self._maybe_start_work()

    # ------------------------------------------------------------------ #
    def _row_for(self, app_id: str) -> Optional[AppInfo]:
        for a in self.app_list:
            if a.app_id == app_id:
                return a
        return None

    def _work_candidates(self, row: AppInfo) -> List[str]:
        """Seeders this leecher may REQ work from, least-loaded first (the
        tracker orders `row.seeders` by reported load)."""
        cands = [s for s in row.seeders if s != self.node_id]
        if row.host_id != self.node_id:
            if row.host_id not in cands:
                cands.insert(0, row.host_id)
        elif not cands:
            # self-leech (paper Scenario III/IV): the host crunches its own
            # application, REQ/DIST looping back through itself
            cands = [self.node_id]
        if not cands:
            return []
        # stable per-leecher rotation spreads first REQs across seeders
        off = sum(ord(c) for c in self.node_id + row.app_id) % len(cands)
        return cands[off:] + cands[:off]

    def _request_work(self, app_id: str) -> bool:
        row = self._row_for(app_id)
        if row is None:
            return False
        tried = self.no_work_from.get(app_id, set())
        for cand in self._work_candidates(row):
            if cand not in tried:
                self.REQ(app_id, cand)
                return True
        return False

    def _on_app_list(self, rows: List[AppInfo]) -> None:
        # an app the tracker advertises again revives: DROP_APP meant "gone
        # now", not "gone forever" — its host may have returned from a
        # crash-restart or a partition-induced false drop
        self.stopped_apps -= {r.app_id for r in rows}
        self.app_list = [r for r in rows if r.app_id not in self.stopped_apps]
        for row in self.app_list:
            if row.manifest is not None:
                local = self.px.manifests.get(row.app_id)
                if local is not None and row.manifest.supersedes(local):
                    # the tracker's row moved to a newer revision (our
                    # MANIFEST_UPDATE was lost, or we were partitioned):
                    # catch up before trusting any seeder set
                    self._apply_manifest_update(row.app_id, row.manifest)
                    local = self.px.manifests.get(row.app_id)
                if local is not None \
                        and local.version != row.manifest.version:
                    # a stale row (older revision than we track) must not
                    # feed its seeder set into our availability plane
                    continue
                self.px.note_full_seeders(row.app_id,
                                          set(row.seeders) | {row.host_id})
                if (row.app_id in self.replicas
                        and self.node_id not in row.seeders):
                    # our SEEDER_UPDATE was lost (or we were dropped while
                    # partitioned): repeat it — the tracker is idempotent
                    self.SEND(self.server_id,
                              Msg(SEEDER_UPDATE, self.node_id,
                                  {"app_id": row.app_id,
                                   "seeder": self.node_id,
                                   "manifest_hash":
                                       self.images.get(row.app_id)},
                                  size_bytes=96))
            # tracker promoted this node from replica to host (origin died)
            if row.host_id == self.node_id and row.app_id in self.replicas:
                app = self.replicas.pop(row.app_id)
                app.host_id = self.node_id
                self.apps[row.app_id] = app
                self.current.pop(row.app_id, None)
                self.STAT()
            # the seeder this leecher worked with vanished: re-route
            ctx = self.current.get(row.app_id)
            if ctx is not None and ctx.get("fetching"):
                self.px.pump(row.app_id)
            elif ctx is not None:
                host = ctx.get("host")
                live = set(row.seeders) | {row.host_id}
                if host is not None and host not in live:
                    ctx["host"] = None
                    if not ctx.get("busy"):
                        self._request_work(row.app_id)
        self._maybe_start_work()

    def _maybe_start_work(self) -> None:
        active = len(self.current)
        now = self.rt.now()
        for row in self.app_list:
            if active >= self.cfg.max_parallel_apps:
                break
            if row.host_id == self.node_id and not self.cfg.self_leech:
                continue
            if row.app_id in self.current:
                continue
            if row.parts_remaining == 0 and row.p > 0 \
                    and not (self.cfg.replicate_completed
                             and row.manifest is not None
                             and row.app_id not in self.images):
                continue    # host reported it complete
            if self.dry_until.get(row.app_id, -1.0) > now:
                continue    # backing off after NO_WORK
            if row.manifest is not None and row.app_id not in self.images:
                # swarm app: fetch the image piece-wise before crunching;
                # the engine announces the join (the tracker relays it so
                # existing members learn about us and vice versa)
                self.current[row.app_id] = {"host": None, "busy": False,
                                            "fetching": True,
                                            "last_req": now}
                self.px.join(row.app_id, row.manifest)
            else:
                if not self._request_work(row.app_id):
                    continue
            active += 1

    def _on_no_work(self, msg: Msg) -> None:
        app_id = msg.payload["app_id"]
        ctx = self.current.get(app_id)
        if ctx is None:
            return
        ctx["awaiting"] = False
        # this seeder is (momentarily) dry; try the next replica before
        # backing off — other seeders may still hold leasable parts
        self.no_work_from[app_id].add(msg.src)
        if self._request_work(app_id):
            return
        self.current.pop(app_id, None)
        self.no_work_from.pop(app_id, None)
        # back off: the app may only be out of *leasable* parts right
        # now (all leased, not all validated) — retry later
        self.dry_until[app_id] = self.rt.now() + self.cfg.retry_s
        self.rt.set_timer(self.node_id, "retry", self.cfg.retry_s)
        self._maybe_start_work()

    def _on_app_data(self, msg: Msg) -> None:
        app_id = msg.payload["app_id"]
        part_id = msg.payload["part_id"]
        ctx = self.current.get(app_id)
        if ctx is None or ctx.get("busy"):
            return
        ctx["awaiting"] = False
        mh = msg.payload.get("manifest_hash")
        if mh is not None and msg.payload.get("app_bytes", 0) > 0:
            # monolithic shipment: the full image rode along, so this agent
            # now holds it and may resolve the executable
            self.images.setdefault(app_id, mh)
        nbytes = self.SCAN(msg.payload)
        ctx["bytes"] = nbytes
        self.no_work_from.get(app_id, set()).discard(msg.src)
        cached = self.part_results.get((app_id, part_id))
        if cached is not None:
            # a different seeder re-leased a part this volunteer already
            # computed: resend the stored result instead of burning a
            # duplicate execution (SAVE/LOAD, endgame dedup)
            self.SEND(msg.src, Msg(RESULT, self.node_id, {
                "app_id": app_id, "part_id": part_id, "result": cached,
                "time_s": 0.0, "data_bytes": 0}, size_bytes=1024))
            return
        self.RUN(app_id, part_id, msg.payload["payload"], msg.src)

    def on_work_done(self, tag, result, elapsed_s: float) -> None:
        app_id, part_id, host_id = tag
        self.TIME(app_id, "end")
        ctx = self.current.get(app_id)
        if ctx is None:
            return      # STOPped while running
        ctx["busy"] = False
        ctx["last_req"] = self.rt.now()
        if result is CANCELLED or ctx.get("drop") == tag:
            # PART_CANCELled execution: discard, keep leeching
            ctx.pop("drop", None)
            ctx["tag"] = None
            self.cancelled_parts += 1
            self._request_work(app_id)
            return
        info = self.COLLECT(app_id, elapsed_s, ctx.get("bytes", 0))
        self.SAVE(app_id, part_id, result)
        loaded = self.LOAD(app_id, part_id)
        final = loaded if loaded is not None else result
        self.part_results[(app_id, part_id)] = final
        # deliver to the live seeder for this app: if the one that leased
        # the part died meanwhile, its successor revalidates the part
        dest = ctx.get("host") or host_id
        self.SEND(dest, Msg(RESULT, self.node_id, {
            "app_id": app_id, "part_id": part_id, "result": final,
            "time_s": info["time_s"], "data_bytes": info["data_bytes"],
        }, size_bytes=1024))
        self.results_log.append((self.rt.now(), app_id, part_id))

    def _on_result_ack(self, msg: Msg) -> None:
        app_id = msg.payload["app_id"]
        if not msg.payload.get("valid", True):
            # the seeder rejected this result: drop the cached copy so any
            # future grant (from a seeder that has not seen the vote)
            # re-executes instead of replaying known-bad data
            self.part_results.pop((app_id, msg.payload["part_id"]), None)
        ctx = self.current.get(app_id)
        if ctx is not None and not ctx.get("busy") \
                and not ctx.get("fetching") and not ctx.get("awaiting"):
            # keep leeching the same app until the host runs dry (the
            # busy/awaiting guards ignore duplicate ACKs, e.g. an owner's
            # late reject after the forwarder's optimistic accept, so one
            # ACK never spawns two competing leases)
            self.REQ(app_id, msg.src)

    def _recover_stalled(self) -> None:
        """Periodic self-heal: re-issue piece requests and work REQs that
        went unanswered (e.g. the peer died before PEER_GONE propagated)."""
        now = self.rt.now()
        # the threshold must sit above any legitimate queueing delay of a
        # bulk APP_DATA/PIECE_DATA transfer (a saturated seeder uplink can
        # hold a reply for a long while) — use the TAIL timescale, same as
        # the seeders' own lease expiry.  Chaos deployments set the
        # dedicated piece_timeout_s lower so lossy links re-request fast.
        stall = self.cfg.work_timeout_s
        piece_stall = self.cfg.piece_timeout_s or stall
        for app_id, ctx in list(self.current.items()):
            if ctx.get("fetching"):
                self.px.recover(app_id, piece_stall)
            elif not ctx.get("busy") and now - ctx.get("last_req",
                                                       0.0) > stall:
                self.no_work_from.pop(app_id, None)
                self._request_work(app_id)
        if now - self._last_server > self.cfg.reregister_s:
            # tracker silence: our REGISTER was lost, or the tracker
            # false-dropped us while our PONGs were dying on a lossy link.
            # Either way it no longer pushes us APP_LISTs — re-register
            # (idempotent at the tracker, throttled to once per window).
            self._last_server = now
            self.SEND(self.server_id, Msg(REGISTER, self.node_id,
                                          {"apps": self._self_rows(),
                                           "boot": self._boot}))

    def on_message(self, msg: Msg) -> None:
        self.RECV(msg)

    def on_timer(self, name: str) -> None:
        if name == "status":
            # replicas must report too: their lease counts feed the
            # tracker's least-loaded routing and promotion choices
            if self.apps or self.replicas:
                self.STAT()
            self._recover_stalled()
        elif name == "tail":
            self.TAIL()
        elif name == "rechoke":
            self.px.rechoke()
        elif name == "gossip":
            self._regossip()
        elif name == "retry":
            self._maybe_start_work()

    def _regossip(self) -> None:
        """Periodic PART_DONE re-gossip (gossip_interval_s): the done sets
        of the seeder ring re-converge even when individual gossip
        messages were lost to the network — receivers are idempotent."""
        for app_id in list(self.apps) + list(self.replicas):
            app = self._seeded_app(app_id)
            if app is None or not app.swarm:
                continue
            done = self._done_parts(app)
            if done:
                self._gossip_part_done(app_id, done)
