"""PieceExchange: the swarm transfer engine behind the agent (paper §V).

Everything about moving application-image *pieces* between volunteers lives
here, extracted from core/agent.py so the transfer scheduler is a layer of
its own (the way BitTorrent separates the peer wire protocol from piece-
selection policy, and the way BOINC separates its transitioner from the
science app).  The Agent keeps only protocol glue: it routes PIECE_*/HAVE/
CHOKE messages into the engine and reacts to the engine's callbacks.

The engine owns, per application:

  * peer state     — who is in the swarm, which pieces each peer holds
                     (HAVE bitmasks, stored as ints), which full seeders
                     exist;
  * selection      — rarest-first piece ordering (core.swarm policy) with a
                     deterministic per-node tie-break rotation, one in-
                     flight request per holder, bounded pipeline;
  * choke scheduling (seeder side) — a fixed number of upload slots;
                     leechers announce INTERESTED, the engine UNCHOKEs the
                     best reciprocators (rolling-window byte *rates*, not
                     lifetime totals) plus one optimistic slot rotated
                     deterministically so newcomers bootstrap; requests
                     from choked peers are refused with CHOKE so the
                     requester re-routes;
  * endgame        — when every missing piece is already in flight, the
                     outstanding requests are duplicated to all other
                     holders (flagged `endgame`, queued by choked holders
                     instead of refused) and reconciled with PIECE_CANCEL
                     the moment the first copy verifies;
  * real bytes     — when the application image is real (Application.image)
                     PIECE_DATA carries the actual payload slice, verified
                     by re-hashing; verified pieces are cached on disk via
                     AgentDirs and reassembled into the replica's Seed copy
                     on completion.  Synthetic (simulation) images move as
                     hash proofs over the identical code path.

Scaling (bitmask-native hot paths).  All per-pump bookkeeping is
incremental so a node's cost per scheduling decision is O(P log P) in the
piece count and *independent of swarm size*:

  * a per-app numpy int32 availability-count array is updated on HAVE
    bitmask deltas, seeder-set changes and PEER_GONE instead of being
    rebuilt O(P·N) on every pump;
  * a per-piece holder index and a cached holder pool replace the per-piece
    O(N) peer rescans;
  * full seeders contribute the same constant to every piece's
    availability, so rarest-first sorts on the partial-holder counts alone
    (`rarest_first_order_np`, an argsort over the count array);
  * real piece payloads are zero-copy `memoryview` slices over one shared
    image buffer, and completed images are interned by manifest hash so N
    replicas cost O(image) memory, not O(N·image).

The pre-optimization paths are kept (`_pump_reference`, `_avail_naive`,
`_holders_naive`) as the reference implementation: differential tests
assert the fast path issues identical requests, and
benchmarks/exchange_bench.py measures the speedup against them.
"""
from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Optional, Set

import numpy as np

from repro_torch.core.messages import (CHOKE, HAVE, INTERESTED, PIECE_CANCEL,
                                 PIECE_DATA, PIECE_REQ, UNCHOKE, Msg)
from repro_torch.core.swarm import rarest_first_order, rarest_first_order_np
from repro_torch.core.workunit import PieceInventory, PieceManifest, mask_nbytes


def iter_bits(mask: int):
    """Yield the set bit positions of an int bitmask, lowest first."""
    while mask:
        low = mask & -mask
        yield low.bit_length() - 1
        mask ^= low


class RollingRate:
    """Sliding-window byte-rate estimator for the rechoke ranking.

    `add(t, n)` records a transfer; `rate(now)` returns bytes/sec over the
    trailing `window_s` seconds.  Replaces the cumulative byte counters in
    choke ranking so a peer that moved bytes long ago stops outranking
    peers that are moving bytes *now* (stale-transfer dominance in
    long-lived swarms was a ROADMAP open item)."""

    __slots__ = ("window_s", "_events", "_total")

    def __init__(self, window_s: float):
        self.window_s = max(window_s, 1e-9)
        self._events: collections.deque = collections.deque()
        self._total = 0

    def add(self, t: float, nbytes: int) -> None:
        self._events.append((t, nbytes))
        self._total += nbytes
        # prune on write as well as read: an estimator that is fed but
        # never ranked (e.g. a seeder we download from but never serve)
        # must not retain one entry per piece forever
        self._prune(t)

    def rate(self, now: float) -> float:
        self._prune(now)
        return self._total / self.window_s

    def _prune(self, now: float) -> None:
        cutoff = now - self.window_s
        ev = self._events
        while ev and ev[0][0] <= cutoff:
            self._total -= ev.popleft()[1]


# Completed real images interned by manifest hash: every node that holds the
# same verified image shares ONE immutable bytes buffer, so a simulation
# with N replicas costs O(image) memory instead of O(N·image).  The keys are
# content-derived (the info-hash covers the per-piece content hashes), so a
# cache hit carries exactly the trust piece verification already
# established.
#
# Entries are REFCOUNTED: every engine that maps an app to the buffer holds
# a reference (acquired in add_local_app/_complete_fetch, released by
# upgrade()/drop_app()).  With versioned manifests each upgrade retires a
# whole image under a hash nobody will ever intern again — without the
# release, 5 upgrades leak 5 full buffers per app.  Unreferenced entries
# are kept as a small LRU dedup tail (a late joiner completing v(k) right
# after everyone upgraded still dedups) bounded by _IMAGE_INTERN_MAX;
# referenced entries are never evicted.
_IMAGE_INTERN: "collections.OrderedDict[str, bytes]" = collections.OrderedDict()
_IMAGE_REFS: Dict[str, int] = {}
_IMAGE_INTERN_MAX = 8


def _evict_unreferenced() -> None:
    excess = sum(1 for mh in _IMAGE_INTERN if mh not in _IMAGE_REFS) \
        - _IMAGE_INTERN_MAX
    if excess <= 0:
        return
    for mh in [m for m in _IMAGE_INTERN if m not in _IMAGE_REFS][:excess]:
        del _IMAGE_INTERN[mh]


def intern_image(manifest_hash: str, image) -> bytes:
    """Insert (or dedup against) the shared buffer AND acquire one
    reference; pair every call with a release_image."""
    cached = _IMAGE_INTERN.get(manifest_hash)
    if cached is None:
        cached = bytes(image) if isinstance(image, memoryview) else image
        _IMAGE_INTERN[manifest_hash] = cached
    else:
        _IMAGE_INTERN.move_to_end(manifest_hash)
    _IMAGE_REFS[manifest_hash] = _IMAGE_REFS.get(manifest_hash, 0) + 1
    _evict_unreferenced()
    return cached


def acquire_image(manifest_hash: str) -> Optional[bytes]:
    """Acquire a reference on an already-interned buffer (None on miss)."""
    cached = _IMAGE_INTERN.get(manifest_hash)
    if cached is not None:
        _IMAGE_INTERN.move_to_end(manifest_hash)
        _IMAGE_REFS[manifest_hash] = _IMAGE_REFS.get(manifest_hash, 0) + 1
    return cached


def release_image(manifest_hash: str) -> None:
    n = _IMAGE_REFS.get(manifest_hash, 0)
    if n <= 1:
        _IMAGE_REFS.pop(manifest_hash, None)
        _evict_unreferenced()
    else:
        _IMAGE_REFS[manifest_hash] = n - 1


def interned_image_count() -> int:
    """Number of interned buffers currently held (the RSS proxy the
    intern-growth regression test bounds across upgrades)."""
    return len(_IMAGE_INTERN)


class PieceExchange:
    """Per-agent swarm transfer engine.

    `send(dst, msg)` and `now()` come from the owning agent; `tracker_id`
    is where join/HAVE announces go for relay.  `on_image_complete(app_id,
    manifest_hash, image_bytes)` fires once per verified image;
    `on_bytes(app_id, n)` accounts received piece payload.
    """

    def __init__(self, node_id: str, cfg, *,
                 send: Callable[[str, Msg], None],
                 now: Callable[[], float],
                 tracker_id: str = "server",
                 dirs=None,
                 on_image_complete: Optional[Callable] = None,
                 on_bytes: Optional[Callable[[str, int], None]] = None,
                 hub=None):
        self.node_id = node_id
        self.cfg = cfg
        self.send = send
        self.now = now
        self.tracker_id = tracker_id
        self.dirs = dirs
        self.on_image_complete = on_image_complete
        self.on_bytes = on_bytes
        # hub mode (core/swarm_arrays.SwarmHub): decisions come from the
        # shared arrays' batched per-tick passes instead of per-message
        # pumps, and the control plane (HAVE fan-out, INTERESTED,
        # UNCHOKE/CHOKE) is applied through the arrays instead of the
        # wire.  Piece traffic stays on the simulated wire either way.
        self.hub = hub
        # False switches pump to the pre-optimization reference path
        # (kept for differential tests and the exchange micro-benchmark)
        self.use_incremental = True
        # --- image / holdings state ------------------------------------- #
        self.manifests: Dict[str, PieceManifest] = {}
        self.inventories: Dict[str, PieceInventory] = {}
        self.complete: Set[str] = set()          # full verified images held
        self.fetching: Set[str] = set()          # apps being leeched
        # real image payloads, as views over the interned shared buffer
        self.image_src: Dict[str, memoryview] = {}
        self.store: Dict[str, Dict[int, Any]] = \
            collections.defaultdict(dict)        # real piece payload views
        # --- swarm peer state -------------------------------------------- #
        self.full_seeders: Dict[str, Set[str]] = collections.defaultdict(set)
        # app -> peer -> HAVE bitmask (bit p set <=> peer holds piece p)
        self.peer_masks: Dict[str, Dict[str, int]] = \
            collections.defaultdict(dict)
        self.swarm_peers: Dict[str, Set[str]] = collections.defaultdict(set)
        self.bad_peers: Dict[str, Set[str]] = collections.defaultdict(set)
        # piece -> {holder: asked_at}; >1 holder only in endgame
        self.pending: Dict[str, Dict[int, Dict[str, float]]] = \
            collections.defaultdict(dict)
        self.peer_load: Dict[str, int] = collections.defaultdict(int)
        # app -> holder -> pieces for which it is the SOLE pending holder
        # (the only requests a CHOKE must re-route); maintained by the
        # _req_* funnel so on_choke touches one holder, not the whole set
        self._sole_pending: Dict[str, Dict[str, Set[int]]] = {}
        # app -> piece -> holders whose request for it went stale
        # (recover()): the re-request prefers an *alternate* holder, so a
        # black-holed link cannot capture a piece's retries forever.
        # Cleared per piece the moment a copy verifies.
        self.stalled_holders: Dict[str, Dict[int, Set[str]]] = {}
        # --- ALTO cost map (tracker COST_MAP; P4P holder preference) ------ #
        # None until a COST_MAP arrives; then holder tie-breaks prefer
        # cheap (same-island) peers.  Shun/stall signals always dominate
        # the cost, so the bias decays when same-island holders starve.
        self.my_island = 0
        self.island_costs: Optional[List[int]] = None
        self.peer_islands: Dict[str, int] = {}
        # --- incremental availability (tentpole) -------------------------- #
        # per-app int32 array: how many *partial* holders have each piece
        # (full seeders add a uniform constant tracked by len(full_seeders))
        self._counts: Dict[str, np.ndarray] = {}
        # per-app, per-piece set of partial holders (the holder index)
        self._piece_holders: Dict[str, List[Set[str]]] = {}
        # cached holder pool; dropped on any membership change
        self._pool_cache: Dict[str, Set[str]] = {}
        # apps whose holder pool is unchanged since the last INTERESTED pass
        self._interest_clean: Set[str] = set()
        # --- choke scheduler (serving side) ------------------------------ #
        self.interested: Dict[str, Set[str]] = collections.defaultdict(set)
        self.unchoked: Dict[str, Set[str]] = collections.defaultdict(set)
        self.opt_unchoked: Dict[str, str] = {}
        self._opt_idx: Dict[str, int] = collections.defaultdict(int)
        self._rechoke_round = 0
        # app -> peer -> queued endgame piece requests (served on unchoke)
        self.queued_reqs: Dict[str, Dict[str, Set[int]]] = \
            collections.defaultdict(dict)
        # --- choke view (leeching side) ---------------------------------- #
        self.unchoked_by: Dict[str, Set[str]] = collections.defaultdict(set)
        self.interest_sent: Dict[str, Set[str]] = collections.defaultdict(set)
        # --- accounting --------------------------------------------------- #
        self.bytes_from: Dict[str, int] = collections.defaultdict(int)
        self.bytes_to: Dict[str, int] = collections.defaultdict(int)
        self._rate_window = float(getattr(cfg, "rate_window_s", 20.0))
        self.rate_from: Dict[str, RollingRate] = {}
        self.rate_to: Dict[str, RollingRate] = {}
        self.pieces_from: Dict[str, Dict[str, int]] = \
            collections.defaultdict(lambda: collections.defaultdict(int))
        self.cancels_sent = 0
        self.dup_piece_data = 0
        # --- versioned-manifest (delta distribution) accounting ----------- #
        # app_id -> manifest_hash of the interned buffer this engine holds
        # a reference on (released on upgrade/drop)
        self._interned: Dict[str, str] = {}
        self.upgrades = 0                # revisions applied locally
        self.reused_pieces = 0           # pieces carried over re-verified
        self.stale_piece_data = 0        # version-mismatched PIECE_DATA
        #                                  discarded (NOT a ban — honest
        #                                  peers on the old revision)
        self.stale_reqs_refused = 0      # version-mismatched PIECE_REQ
        self.stale_have_demoted = 0      # old-version HAVEs that demoted
        #                                  the announcing peer
        # tripwire for the mixed-version invariant: a version-mismatched
        # payload must NEVER reach the inventory.  Incremented only if the
        # discard gate is bypassed; chaos scenarios assert it stays 0.
        self.stale_accepts = 0

    # ======================== ALTO cost map (P4P) ======================= #
    def set_cost_map(self, island: int, costs: List[int],
                     islands: Optional[Dict[str, int]] = None) -> None:
        """Install the tracker's COST_MAP: this node's island, its
        endpoint-cost row (cost to every island), and the peer->island
        directory.  Idempotent; a re-REGISTER just refreshes it."""
        self.my_island = int(island)
        self.island_costs = list(costs)
        if islands:
            self.peer_islands.update(islands)

    def _peer_cost(self, peer: str) -> int:
        """ALTO cost to a peer; 0 before any COST_MAP arrives (flat
        world), and pessimistically the most expensive known cost for
        peers the directory does not list."""
        if self.island_costs is None:
            return 0
        isl = self.peer_islands.get(peer)
        if isl is None or not 0 <= isl < len(self.island_costs):
            return max(self.island_costs)
        return self.island_costs[isl]

    # ===================== lifecycle / membership ======================= #
    def add_local_app(self, app_id: str, manifest: PieceManifest,
                      image=None) -> None:
        """Register an app whose full image this node already holds (origin
        seeder, or a replica restored from disk)."""
        self.manifests[app_id] = manifest
        self.complete.add(app_id)
        if image is not None:
            if manifest.content_hashed:
                image = intern_image(manifest.manifest_hash, image)
                self._track_intern(app_id, manifest.manifest_hash)
            self.image_src[app_id] = memoryview(image)
        if self.hub is not None:
            self.hub.register_seed(self, app_id, manifest)

    def _track_intern(self, app_id: str, manifest_hash: str) -> None:
        """Record that this engine holds one intern reference for the app,
        releasing any reference it held for a previous revision."""
        old = self._interned.get(app_id)
        if old == manifest_hash:
            release_image(manifest_hash)     # already held: keep one ref
            return
        if old is not None:
            release_image(old)
        self._interned[app_id] = manifest_hash

    def join(self, app_id: str, manifest: PieceManifest) -> None:
        """Start leeching an app image piece-wise; announces the bitfield
        to the tracker so swarm members discover each other.  An intact
        on-disk piece cache (an agent restarting mid-download) is re-hashed
        into the inventory first, so only the genuinely missing pieces are
        fetched."""
        self.manifests.setdefault(app_id, manifest)
        inv = self.inventories.setdefault(app_id, PieceInventory(manifest))
        self.fetching.add(app_id)
        if self.hub is not None:
            # hub mode: the shared arrays replace the tracker announce +
            # HAVE relay discovery loop; cache-restored pieces are folded
            # into the swarm-wide availability directly
            self.hub.register_leech(self, app_id, manifest)
            self._rescan_cache(app_id, inv)
            for piece_id in inv.have:
                self.hub.note_have(self, app_id, piece_id)
            if inv.complete:
                self._complete_fetch(app_id)
            return
        # build the availability index now: announces that arrived before
        # the manifest get folded in (and complete peers promoted) here
        self._arrays(app_id)
        self._rescan_cache(app_id, inv)
        self.send(self.tracker_id, self._have_msg(app_id))
        if inv.complete:
            self._complete_fetch(app_id)
        else:
            self.pump(app_id)

    def _rescan_cache(self, app_id: str, inv: PieceInventory) -> int:
        """Restart support (ROADMAP open item): verify pieces cached under
        Leech/App/<id>/Pieces back into the inventory instead of
        re-fetching everything.  Corrupt or foreign cache files are
        deleted so the pieces are fetched from the swarm.  Returns the
        number of pieces restored."""
        if self.dirs is None or inv.have or not inv.manifest.content_hashed:
            return 0
        restored = 0
        for piece_id in self.dirs.list_pieces(app_id):
            data = (self.dirs.load_piece(app_id, piece_id)
                    if 0 <= piece_id < inv.manifest.n_pieces else None)
            if data is not None and inv.add(piece_id, data=data):
                self.store[app_id][piece_id] = data
                restored += 1
            else:
                self.dirs.drop_piece(app_id, piece_id)
        return restored

    def note_full_seeders(self, app_id: str, seeders: Set[str]) -> None:
        seeders = set(seeders)
        if seeders != self.full_seeders.get(app_id):
            # guard: APP_LIST re-pushes the same set every refresh; only a
            # real change may invalidate the cached holder pool
            self.full_seeders[app_id] = seeders
            self._pool_changed(app_id)

    # ================== versioned manifests (delta path) ================= #
    def _reset_swarm_view(self, app_id: str) -> None:
        """Forget everything known about the swarm FOR THE PREVIOUS
        revision: masks, availability, seeder sets, in-flight requests and
        upload grants all describe v(k) holdings and must never leak into
        v(k+1) scheduling.  Swarm *membership* (who to announce to) is
        kept — the same nodes are upgrading with us."""
        self._req_drop_app(app_id)
        self.stalled_holders.pop(app_id, None)
        self.peer_masks.pop(app_id, None)
        self.full_seeders.pop(app_id, None)
        self._counts.pop(app_id, None)
        self._piece_holders.pop(app_id, None)
        self._pool_cache.pop(app_id, None)
        self._interest_clean.discard(app_id)
        self.interest_sent.pop(app_id, None)
        # upload grants belong to the old revision too; no CHOKE burst is
        # needed — our v(k+1) HAVE makes old-version peers drop us, and a
        # straggler's request bounces off the version gate with a HAVE
        self.interested.pop(app_id, None)
        self.unchoked.pop(app_id, None)
        self.opt_unchoked.pop(app_id, None)
        self.queued_reqs.pop(app_id, None)

    def _read_old_piece(self, app_id: str, old_manifest: PieceManifest,
                        old_image, old_store: Dict[int, Any], piece_id: int):
        """Bytes of a piece as held under the previous revision (shared
        image view, per-piece store, or the on-disk cache)."""
        if old_image is not None:
            lo = piece_id * old_manifest.piece_bytes
            return old_image[lo:lo + old_manifest.piece_bytes]
        data = old_store.get(piece_id)
        if data is None and self.dirs is not None:
            data = self.dirs.load_piece(app_id, piece_id)
        return data

    def upgrade(self, app_id: str, new_manifest: PieceManifest,
                image=None, full: bool = False) -> bool:
        """Move the app to a newer manifest revision (delta distribution).

        Pieces unchanged per `new_manifest.delta(old)` that this node
        already holds verified are carried over — re-read and re-HASHED
        for content-hashed manifests (the reuse rule: a reused piece is
        never trusted on faith) — so only the changed pieces are fetched
        from the swarm.  `full=True` is the publisher path: this node
        holds the complete new revision outright (`image` for real apps).
        Returns False for stale/duplicate updates (version not newer) or
        unknown apps."""
        old = self.manifests.get(app_id)
        if old is None or not new_manifest.supersedes(old):
            return False
        old_inv = self.inventories.get(app_id)
        if old_inv is None and app_id in self.complete:
            old_inv = PieceInventory(old, complete=True)
        self.upgrades += 1
        self._reset_swarm_view(app_id)
        if self.hub is not None:
            self.hub.retire(self, app_id, old)
        self.manifests[app_id] = new_manifest
        old_image = self.image_src.pop(app_id, None)
        old_store = self.store.pop(app_id, None) or {}
        self.complete.discard(app_id)
        if full:
            # publisher: complete new image by fiat (real bytes or a
            # synthetic revision), release the superseded interned buffer
            self.inventories.pop(app_id, None)
            self.fetching.discard(app_id)
            self.complete.add(app_id)
            if image is not None and new_manifest.content_hashed:
                image = intern_image(new_manifest.manifest_hash, image)
                self._track_intern(app_id, new_manifest.manifest_hash)
            else:
                mh = self._interned.pop(app_id, None)
                if mh is not None:
                    release_image(mh)
            if image is not None:
                self.image_src[app_id] = memoryview(image)
                if self.dirs is not None:
                    self.dirs.save_seed_image(app_id, bytes(image))
            if self.hub is not None:
                self.hub.register_seed(self, app_id, new_manifest)
            else:
                self.send(self.tracker_id, self._have_msg(app_id))
            return True
        # leecher: seed the new inventory from still-valid old pieces
        reads: Dict[int, Any] = {}

        def read_piece(piece_id: int):
            data = reads.get(piece_id)
            if data is None:
                data = self._read_old_piece(app_id, old, old_image,
                                            old_store, piece_id)
                if data is not None:
                    reads[piece_id] = data
            return data

        new_inv = PieceInventory(new_manifest)
        adopted = (new_inv.seed_from(old_inv, read_piece)
                   if old_inv is not None else set())
        self.reused_pieces += len(adopted)
        self.inventories[app_id] = new_inv
        if new_manifest.content_hashed:
            self.store[app_id] = {pid: reads[pid] for pid in adopted}
            if self.dirs is not None:
                for pid in self.dirs.list_pieces(app_id):
                    if pid not in adopted:
                        self.dirs.drop_piece(app_id, pid)
                for pid in adopted:
                    self.dirs.save_piece(app_id, pid, reads[pid])
        # the superseded buffer's intern slot is released now; adopted
        # slices keep the underlying bytes alive only until completion
        # reassembles (and interns) the new image
        mh = self._interned.pop(app_id, None)
        if mh is not None:
            release_image(mh)
        self.fetching.add(app_id)
        if self.hub is not None:
            self.hub.register_leech(self, app_id, new_manifest)
            for piece_id in new_inv.have:
                self.hub.note_have(self, app_id, piece_id)
            if new_inv.complete:
                self._complete_fetch(app_id)
            return True
        # one v(k+1) announce to the tracker and known swarm peers: seeds
        # the new availability plane AND demotes us from v(k) pools
        announce = self._have_msg(app_id)
        for target in sorted(self.swarm_peers.get(app_id, set()) -
                             {self.node_id}):
            self.send(target, announce)
        self.send(self.tracker_id, announce)
        if new_inv.complete:
            self._complete_fetch(app_id)
        else:
            self.pump(app_id)
        return True

    def drop_app(self, app_id: str, keep_image: bool = False) -> None:
        """Forget an app (STOP).  `keep_image` preserves the manifest and
        payload for apps this node still seeds as origin."""
        self._req_drop_app(app_id)
        self.fetching.discard(app_id)
        self.inventories.pop(app_id, None)
        self.stalled_holders.pop(app_id, None)
        self.peer_masks.pop(app_id, None)
        self._counts.pop(app_id, None)
        self._piece_holders.pop(app_id, None)
        self._pool_cache.pop(app_id, None)
        self._interest_clean.discard(app_id)
        self.swarm_peers.pop(app_id, None)
        self.full_seeders.pop(app_id, None)
        self.bad_peers.pop(app_id, None)
        self.interested.pop(app_id, None)
        self.unchoked.pop(app_id, None)
        self.opt_unchoked.pop(app_id, None)
        self.queued_reqs.pop(app_id, None)
        self.unchoked_by.pop(app_id, None)
        self.interest_sent.pop(app_id, None)
        if not keep_image:
            self.complete.discard(app_id)
            self.manifests.pop(app_id, None)
            self.image_src.pop(app_id, None)
            self.store.pop(app_id, None)
            mh = self._interned.pop(app_id, None)
            if mh is not None:
                release_image(mh)

    def on_peer_gone(self, node: str) -> None:
        # hub mode: the runtime's crash hook already reset the node's row
        # (PEER_GONE relays can trail a restart; acting on them here
        # would wipe the fresh incarnation's state) — only the local
        # per-engine bookkeeping below needs cleaning
        for app_id, masks in self.peer_masks.items():
            mask = masks.pop(node, None)
            if mask:
                counts = self._counts.get(app_id)
                if counts is not None:
                    holders = self._piece_holders[app_id]
                    # stored masks may carry out-of-range bits from
                    # announces that arrived before the manifest was
                    # known; the counts only ever covered valid pieces
                    for p in iter_bits(mask & ((1 << len(counts)) - 1)):
                        counts[p] -= 1
                        holders[p].discard(node)
                self._pool_changed(app_id)
        self.rate_from.pop(node, None)
        self.rate_to.pop(node, None)
        for app_id, peers in self.full_seeders.items():
            if node in peers:
                peers.discard(node)
                self._pool_changed(app_id)
        for peers in self.interested.values():
            peers.discard(node)
        for peers in self.unchoked.values():
            peers.discard(node)
        for peers in self.unchoked_by.values():
            peers.discard(node)
        for peers in self.interest_sent.values():
            peers.discard(node)
        for peers in self.swarm_peers.values():
            peers.discard(node)
        for queued in self.queued_reqs.values():
            queued.pop(node, None)
        self.peer_load.pop(node, None)
        for app_id in list(self.pending):
            pending = self.pending[app_id]
            stranded = [p for p, asked in pending.items() if node in asked]
            for piece in stranded:
                # the load counter is already gone wholesale (popped
                # above): don't let the decrement resurrect it at 0
                self._req_del(app_id, piece, node, dec_load=False)
            if stranded:
                self.pump(app_id)

    # ====================== queries for the agent ======================= #
    def bitfield_mask(self, app_id: str) -> int:
        if app_id in self.complete:
            manifest = self.manifests.get(app_id)
            return manifest.full_mask if manifest else 0
        inv = self.inventories.get(app_id)
        return inv.bitfield() if inv else 0

    def image_bytes(self, app_id: str) -> Optional[memoryview]:
        """Zero-copy view of the app's real image (None for synthetic)."""
        return self.image_src.get(app_id)

    def seed_load(self, app_id: str) -> int:
        """Upload pressure this node's choke scheduler sees for an app:
        granted slots plus endgame requests queued behind them.  Reported
        to the tracker (via STATUS loads) for least-loaded routing."""
        queued = sum(len(ps) for ps in
                     self.queued_reqs.get(app_id, {}).values())
        return len(self.unchoked.get(app_id, ())) + queued

    def assembled_image(self, app_id: str) -> Optional[bytes]:
        """Reassemble a completed real image from the in-memory store or
        the on-disk piece cache; None for synthetic images."""
        manifest = self.manifests.get(app_id)
        if manifest is None:
            return None
        src = self.image_src.get(app_id)
        if src is not None:
            return bytes(src)
        store = self.store.get(app_id, {})
        if len(store) == manifest.n_pieces:
            return b"".join(store[p] for p in range(manifest.n_pieces))
        if self.dirs is not None:
            return self.dirs.assemble_image(app_id, manifest.n_pieces)
        return None

    # ============ incremental availability / holder index =============== #
    def _pool_changed(self, app_id: str) -> None:
        """Swarm membership changed: drop the cached holder pool and allow
        a fresh INTERESTED pass toward any new holders."""
        self._pool_cache.pop(app_id, None)
        self._interest_clean.discard(app_id)

    def _ban(self, app_id: str, peer: str) -> None:
        self.bad_peers[app_id].add(peer)
        self._pool_changed(app_id)

    def _arrays(self, app_id: str):
        """The availability count array and per-piece holder index; built
        lazily (HAVE announces may precede the manifest) and maintained
        incrementally afterwards."""
        counts = self._counts.get(app_id)
        if counts is None:
            manifest = self.manifests.get(app_id)
            if manifest is None:
                return None, None
            n = manifest.n_pieces
            counts = np.zeros(n, dtype=np.int32)
            holders: List[Set[str]] = [set() for _ in range(n)]
            full = manifest.full_mask
            for peer, mask in self.peer_masks.get(app_id, {}).items():
                for p in iter_bits(mask & full):
                    counts[p] += 1
                    holders[p].add(peer)
                if mask & full == full:
                    # a peer whose completing announce arrived before the
                    # manifest was known is recognised as a seeder now —
                    # the per-announce promotion check only runs on deltas
                    self._promote_full_seeder(app_id, peer)
            self._counts[app_id] = counts
            self._piece_holders[app_id] = holders
        return counts, self._piece_holders.get(app_id)

    def avail_array(self, app_id: str) -> Optional[np.ndarray]:
        """Current per-piece availability (partial holders + full seeders)
        as int32 — the incrementally maintained structure the differential
        tests compare against `_avail_naive`."""
        counts, _ = self._arrays(app_id)
        if counts is None:
            return None
        return counts + np.int32(len(self.full_seeders.get(app_id, ())))

    def _avail_naive(self, app_id: str) -> Dict[int, int]:
        """Reference (pre-optimization) availability map: full O(P·N)
        rebuild from the stored peer masks."""
        n_full = len(self.full_seeders.get(app_id, ()))
        avail: Dict[int, int] = collections.defaultdict(lambda: 0)
        manifest = self.manifests.get(app_id)
        full = None
        if manifest is not None:
            full = manifest.full_mask
            for p in range(manifest.n_pieces):
                avail[p] = n_full
        for mask in self.peer_masks.get(app_id, {}).values():
            if full is not None:
                mask &= full
            for p in iter_bits(mask):
                avail[p] += 1
        return avail

    # ========================= piece selection ========================== #
    def _holder_pool(self, app_id: str) -> Set[str]:
        """Peers holding at least one piece (full seeders + partial
        holders), excluding ourselves and banned peers.  Cached until the
        membership changes; callers must not mutate the returned set."""
        pool = self._pool_cache.get(app_id)
        if pool is None:
            pool = set(self.full_seeders.get(app_id, ()))
            for peer, mask in self.peer_masks.get(app_id, {}).items():
                if mask:
                    pool.add(peer)
            pool.discard(self.node_id)
            pool -= self.bad_peers.get(app_id, set())
            if self.cfg.fetch_from:
                # origin-only mode: the whole request plane collapses to
                # the allow-listed peers (interest, pump and endgame all
                # draw their candidates from this pool or _holders)
                pool &= set(self.cfg.fetch_from)
            self._pool_cache[app_id] = pool
        return pool

    def _holders(self, app_id: str, piece_id: int) -> List[str]:
        """Peers this node may fetch `piece_id` from, via the per-piece
        holder index (full seeders hold everything by definition)."""
        if not self.use_incremental:
            return self._holders_naive(app_id, piece_id)
        cands = set(self.full_seeders.get(app_id, ()))
        _, holders = self._arrays(app_id)
        if holders is not None:
            cands |= holders[piece_id]
        cands.discard(self.node_id)
        bad = self.bad_peers.get(app_id)
        if bad:
            cands -= bad
        if self.cfg.fetch_from:
            cands &= set(self.cfg.fetch_from)
        return sorted(cands)

    def _holders_naive(self, app_id: str, piece_id: int) -> List[str]:
        """Reference holder scan: rebuilds the pool and tests each member
        for the piece, as the pre-index implementation did."""
        full = self.full_seeders.get(app_id, ())
        by_peer = self.peer_masks.get(app_id, {})
        pool = set(full)
        for peer, mask in by_peer.items():
            if mask:
                pool.add(peer)
        pool.discard(self.node_id)
        pool -= self.bad_peers.get(app_id, set())
        if self.cfg.fetch_from:
            pool &= set(self.cfg.fetch_from)
        return sorted(p for p in pool
                      if p in full or (by_peer.get(p, 0) >> piece_id) & 1)

    def _usable(self, app_id: str, peer: str) -> bool:
        """May we address a normal (non-endgame) request to `peer`?
        Choking is the HOLDER's policy, so this is gated on its UNCHOKE
        regardless of our own cfg.choke — requesting anyway would just
        bounce off a CHOKE and spin."""
        return peer in self.unchoked_by[app_id]

    def _express_interest(self, app_id: str) -> None:
        inv = self.inventories.get(app_id)
        if inv is None or inv.complete:
            return
        sent = self.interest_sent[app_id]
        for peer in sorted(self._holder_pool(app_id) - sent):
            sent.add(peer)
            self.send(peer, Msg(INTERESTED, self.node_id,
                                {"app_id": app_id}, size_bytes=64))

    # ===================== pending-request funnel ======================= #
    # Every mutation of the `pending` dicts goes through the four helpers
    # below.  They keep three things consistent in one place: the
    # per-holder load counters, the sole-pending-by-holder index that
    # on_choke re-routes from, and (hub mode) the batched engine's
    # array-native request ledger.

    def _sole_del(self, app_id: str, peer: str, piece_id: int) -> None:
        sp = self._sole_pending.get(app_id)
        held = sp.get(peer) if sp else None
        if held is not None:
            held.discard(piece_id)
            if not held:
                del sp[peer]

    def _req_add(self, app_id: str, piece_id: int, peer: str,
                 now: float) -> None:
        """Record an issued request (`peer` is not yet asked for the
        piece — pump/endgame guarantee that)."""
        pending = self.pending[app_id]
        asked = pending.get(piece_id)
        if asked is None:
            pending[piece_id] = {peer: now}
            self._sole_pending.setdefault(app_id, {}) \
                .setdefault(peer, set()).add(piece_id)
        else:
            if len(asked) == 1:
                # an endgame duplicate: the previous holder stops being
                # the sole one on the hook for this piece
                self._sole_del(app_id, next(iter(asked)), piece_id)
            asked[peer] = now
        self.peer_load[peer] += 1
        if self.hub is not None:
            self.hub.ledger_add(self, app_id, piece_id, peer, now)

    def _req_del(self, app_id: str, piece_id: int, peer: str,
                 dec_load: bool = True) -> bool:
        """Withdraw one (piece, holder) entry; True when it existed.
        `dec_load=False` for peers whose load counter was already
        dropped wholesale (on_peer_gone pops it first)."""
        pending = self.pending.get(app_id)
        asked = pending.get(piece_id) if pending else None
        if asked is None or peer not in asked:
            return False
        del asked[peer]
        if dec_load:
            self.peer_load[peer] = max(0, self.peer_load[peer] - 1)
        self._sole_del(app_id, peer, piece_id)
        if not asked:
            del pending[piece_id]
        elif len(asked) == 1:
            self._sole_pending.setdefault(app_id, {}) \
                .setdefault(next(iter(asked)), set()).add(piece_id)
        if self.hub is not None:
            self.hub.ledger_del(self, app_id, piece_id, peer)
        return True

    def _req_clear(self, app_id: str,
                   piece_id: int) -> Optional[Dict[str, float]]:
        """Drop a piece's whole pending entry (reconcile: the piece
        verified).  Returns the removed holder->asked_at dict so the
        caller can PIECE_CANCEL the losers."""
        pending = self.pending.get(app_id)
        asked = pending.pop(piece_id, None) if pending else None
        if not asked:
            return asked
        for holder in asked:
            self.peer_load[holder] = max(0, self.peer_load[holder] - 1)
            self._sole_del(app_id, holder, piece_id)
        if self.hub is not None:
            self.hub.ledger_clear(self, app_id, piece_id)
        return asked

    def _req_drop_app(self, app_id: str) -> None:
        """Forget every in-flight request for the app (STOP / revision
        reset)."""
        for asked in self.pending.pop(app_id, {}).values():
            for peer in asked:
                self.peer_load[peer] = max(0, self.peer_load[peer] - 1)
        self._sole_pending.pop(app_id, None)
        if self.hub is not None:
            self.hub.ledger_drop(self, app_id)

    def _route_choked(self, app_id: str, peer: str) -> None:
        """A CHOKE from `peer`: re-route the requests solely pending at
        it (endgame duplicates stay queued at the holder; a sole request
        must move elsewhere or the piece stalls).  The holder index makes
        this O(requests at peer), not O(whole pending set)."""
        held = self._sole_pending.get(app_id, {}).get(peer)
        if not held:
            return
        for piece_id in sorted(held):
            self._req_del(app_id, piece_id, peer)

    def pump(self, app_id: str) -> None:
        """Issue PIECE_REQs, rarest-first, to the least-loaded unchoked
        holders; fall into endgame when everything missing is in flight.

        Cost per call is O(P log P) (argsort of the maintained count
        array) plus O(1) per issued request — and O(1) outright when the
        pipeline is already full, which is the common case for the pumps
        triggered by every HAVE announce in a busy swarm."""
        if self.hub is not None:
            # hub mode: requests are matched in the next batched tick
            self.hub.mark_dirty(self, app_id)
            return
        if not self.use_incremental:
            return self._pump_reference(app_id)
        inv = self.inventories.get(app_id)
        if inv is None or inv.complete:
            return
        if app_id not in self._interest_clean:
            self._express_interest(app_id)
            self._interest_clean.add(app_id)
        pending = self.pending[app_id]
        n_pieces = inv.manifest.n_pieces
        if (len(pending) < self.cfg.piece_pipeline
                and n_pieces - len(inv.have) > len(pending)):
            # at most one in-flight request per holder: committing several
            # pieces to one uplink queues them behind each other while
            # other holders idle, and starves the seeder-egress reduction
            busy = {peer for asked in pending.values() for peer in asked}
            usable = (self.unchoked_by[app_id]
                      & self._holder_pool(app_id)) - busy
            if usable:
                missing = [p for p in inv.missing() if p not in pending]
                counts, holders = self._arrays(app_id)
                # stable per-node offset staggers tie-breaks so leechers
                # start on different pieces (random-first-piece,
                # deterministically)
                off = sum(ord(c) for c in self.node_id + app_id)
                # full seeders add the same constant to every piece's
                # availability, so sorting on partial counts alone
                # preserves the rarest-first order
                order = rarest_first_order_np(missing, counts, offset=off,
                                              n_pieces=n_pieces)
                usable_full = usable & self.full_seeders.get(app_id, set())
                stalled = self.stalled_holders.get(app_id, {})
                now = self.now()
                for piece_id in order:
                    if (len(pending) >= self.cfg.piece_pipeline
                            or not usable):
                        break
                    cands = usable_full | (usable & holders[piece_id])
                    if not cands:
                        continue
                    shun = stalled.get(piece_id, ())
                    # holder tie-break: never-shunned first, then cheapest
                    # island (P4P; 0 for everyone without a cost map, so
                    # the flat order is unchanged), then least loaded
                    peer = min(cands, key=lambda h: (
                        h in shun, self._peer_cost(h),
                        self.peer_load.get(h, 0), h))
                    self._req_add(app_id, piece_id, peer, now)
                    usable.discard(peer)
                    usable_full.discard(peer)
                    self._send_req(app_id, piece_id, peer)
        # endgame only once real progress exists AND everything still
        # missing is already in flight: duplicating the very first
        # requests (e.g. a one-piece image) would multiply seeder egress
        # for transfers that are not tail-latency bound at all
        if (self.cfg.endgame and pending and inv.have
                and n_pieces - len(inv.have) == len(pending)):
            self._endgame(app_id)

    def _pump_reference(self, app_id: str) -> None:
        """The pre-optimization pump: full availability rebuild and
        per-piece holder-pool rescans, O(P·N) per call.  Kept verbatim so
        the differential tests can assert the fast path issues identical
        requests and the micro-benchmark has an honest baseline."""
        inv = self.inventories.get(app_id)
        if inv is None or inv.complete:
            return
        self._express_interest(app_id)
        pending = self.pending[app_id]
        missing = [p for p in inv.missing() if p not in pending]
        off = sum(ord(c) for c in self.node_id + app_id)
        order = rarest_first_order(missing, self._avail_naive(app_id),
                                   offset=off,
                                   n_pieces=inv.manifest.n_pieces)
        now = self.now()
        busy = {peer for asked in pending.values() for peer in asked}
        for piece_id in order:
            if len(pending) >= self.cfg.piece_pipeline:
                break
            holders = [h for h in self._holders_naive(app_id, piece_id)
                       if h not in busy and self._usable(app_id, h)]
            if not holders:
                continue
            peer = min(holders, key=lambda h: (self.peer_load.get(h, 0), h))
            self._req_add(app_id, piece_id, peer, now)
            busy.add(peer)
            self._send_req(app_id, piece_id, peer)
        if (self.cfg.endgame and pending and inv.have and not
                [p for p in inv.missing() if p not in pending]):
            self._endgame(app_id)

    def _send_req(self, app_id: str, piece_id: int, peer: str,
                  endgame: bool = False) -> None:
        payload = {"app_id": app_id, "piece_id": piece_id}
        v = self._version(app_id)
        if v is not None:
            payload["v"] = v
        if endgame:
            payload["endgame"] = True
        self.send(peer, Msg(PIECE_REQ, self.node_id, payload, size_bytes=96))

    def _endgame(self, app_id: str) -> None:
        """Every missing piece is in flight: duplicate each outstanding
        request to other holders (choked ones queue it) so one slow uplink
        cannot stall completion; PIECE_CANCEL reconciles the losers.

        Holders whose earlier request for the piece went stale
        (`stalled_holders`) are skipped: with a deterministic holder order
        and a duplication cap, re-asking the same silent trio forever
        would pin the piece to peers that never deliver while willing
        seeders idle one name further down the list."""
        pending = self.pending[app_id]
        stalled = self.stalled_holders.get(app_id, {})
        now = self.now()
        cap = max(int(getattr(self.cfg, "endgame_dup", 3)), 1)
        for piece_id, asked in pending.items():
            if len(asked) >= cap:
                continue
            shun = stalled.get(piece_id, ())
            holders = self._holders(app_id, piece_id)
            if self.island_costs is not None:
                # P4P: duplicate to same-island holders first (shunned
                # ones are skipped below regardless of cost, so the bias
                # decays when the cheap holders starve)
                holders = sorted(holders,
                                 key=lambda h: (self._peer_cost(h), h))
            for holder in holders:
                if holder in asked or holder in shun:
                    continue
                self._req_add(app_id, piece_id, holder, now)
                self._send_req(app_id, piece_id, holder, endgame=True)
                if len(asked) >= cap:
                    break

    # ======================== message handlers ========================== #
    def _note_peer_mask(self, app_id: str, peer: str,
                        mask: Optional[int]) -> bool:
        """Merge a peer's HAVE bitmask into the swarm state, updating the
        availability counts and holder index incrementally.  Returns True
        when availability actually changed, so callers can skip redundant
        pumps on no-op announces."""
        if mask is None or peer == self.node_id:
            return False
        masks = self.peer_masks[app_id]
        old = masks.get(peer, 0)
        if old | mask == old:
            # no new bits — the common case once a swarm warms up; only
            # record first contact (a join announce with an empty mask)
            if peer not in masks:
                masks[peer] = old
            return False
        manifest = self.manifests.get(app_id)
        if manifest is not None:
            mask &= manifest.full_mask           # ignore out-of-range bits
        new = old | mask
        masks[peer] = new
        delta = new & ~old
        if not delta:
            return False
        counts = self._counts.get(app_id)
        if counts is not None:
            holders = self._piece_holders[app_id]
            for p in iter_bits(delta):
                counts[p] += 1
                holders[p].add(peer)
        if old == 0:
            self._pool_changed(app_id)           # a new holder appeared
        # promotion must ignore any out-of-range bits stored while the
        # manifest was still unknown
        if manifest is not None \
                and new & manifest.full_mask == manifest.full_mask:
            self._promote_full_seeder(app_id, peer)
        return True

    def _sync_peer_mask(self, app_id: str, peer: str, mask: int) -> bool:
        """Authoritative holdings snapshot, straight from the peer itself
        (a direct HAVE, not a relay): unlike the grow-only merge, bits the
        peer no longer announces are REMOVED.  A crash-restarted peer
        loses its pieces but keeps its node id — without reconciling
        downward, its stale full mask makes every leecher spin a
        request/refusal loop against a peer that holds nothing."""
        if mask is None or peer == self.node_id:
            return False
        manifest = self.manifests.get(app_id)
        masks = self.peer_masks[app_id]
        old = masks.get(peer)
        if manifest is None or old is None:
            # no manifest to validate against, or first contact: the
            # grow-only merge already does the right thing
            return self._note_peer_mask(app_id, peer, mask)
        new = mask & manifest.full_mask
        if new != manifest.full_mask \
                and peer in self.full_seeders.get(app_id, ()):
            # demote BEFORE the no-change early return: the peer itself
            # says it no longer holds everything.  A stale tracker row
            # (APP_LIST re-pushes the old seeder set every refresh) can
            # re-promote a crash-restarted seeder between two identical
            # snapshots — without re-demoting here, endgame re-requests
            # live-lock against the phantom seeder (REQ -> "don't have
            # it" HAVE -> re-route -> _holders offers it again via
            # full_seeders -> REQ ...) at link latency, and the heap
            # grows without sim time advancing.
            self.full_seeders[app_id].discard(peer)
            if not new and not old:
                # it was in the holder pool only as a seeder
                self._pool_changed(app_id)
            if new == old:
                return True          # availability changed: full -> partial
        if new == old:
            return False
        masks[peer] = new
        counts = self._counts.get(app_id)
        if counts is not None:
            holders = self._piece_holders[app_id]
            for p in iter_bits(old & ~new):
                counts[p] -= 1
                holders[p].discard(peer)
            for p in iter_bits(new & ~old):
                counts[p] += 1
                holders[p].add(peer)
        if (old == 0) != (new == 0):
            # the cached holder pool only tracks *membership*: invalidate
            # when the peer enters or leaves it, not on every mask delta
            # (the grow-only merge has the same rule — a per-announce
            # invalidation would put an O(N) pool rebuild back on the
            # HAVE hot path the holder-pool caching removed)
            self._pool_changed(app_id)
        if new == manifest.full_mask:
            self._promote_full_seeder(app_id, peer)
        return True

    def _drop_peer_pending(self, app_id: str, peer: str) -> bool:
        """Withdraw every in-flight request parked at `peer` for the app
        (it turned out to be on a different manifest revision).  Returns
        True when anything was dropped."""
        pending = self.pending.get(app_id)
        if not pending:
            return False
        dropped = False
        for piece_id in [p for p, asked in pending.items() if peer in asked]:
            self._req_del(app_id, piece_id, peer)
            dropped = True
        return dropped

    def _promote_full_seeder(self, app_id: str, peer: str) -> None:
        """The peer completed the image: it is a seeder now, not a
        leecher — release any upload slot it held."""
        if peer not in self.full_seeders[app_id]:
            self.full_seeders[app_id].add(peer)
            self._pool_changed(app_id)
        self.interested[app_id].discard(peer)
        self.unchoked[app_id].discard(peer)
        self.queued_reqs[app_id].pop(peer, None)

    def _version(self, app_id: str) -> Optional[int]:
        manifest = self.manifests.get(app_id)
        return manifest.version if manifest is not None else None

    def _have_msg(self, app_id: str, peer: Optional[str] = None) -> Msg:
        mask = self.bitfield_mask(app_id)
        payload = {"app_id": app_id, "mask": mask}
        v = self._version(app_id)
        if v is not None:
            payload["v"] = v
        if peer is not None:
            payload["peer"] = peer
        return Msg(HAVE, self.node_id, payload,
                   size_bytes=96 + mask_nbytes(mask))

    def _stale_version(self, app_id: str, v: Optional[int]) -> bool:
        """Does a message tagged with manifest version `v` mismatch the
        revision this node currently tracks?  Untagged messages (pre-
        versioning peers, unit harnesses) are treated as current."""
        if v is None:
            return False
        local = self._version(app_id)
        return local is not None and v != local

    def on_have(self, msg: Msg) -> None:
        payload = msg.payload
        app_id = payload["app_id"]
        # the tracker relays announces with the originating peer attached
        peer = payload.get("peer", msg.src)
        if peer == self.node_id:
            return
        self.swarm_peers[app_id].add(peer)
        if self._stale_version(app_id, payload.get("v")):
            # mixed-version isolation: a mask for a different revision of
            # the image must NEVER merge into this revision's availability.
            # A crash-restarted peer re-announcing its v(k) mask after the
            # swarm moved to v(k+1) is DEMOTED (its pieces are stale, its
            # full-seeder claim doubly so); a peer that is AHEAD of us is
            # removed from our pool too — it stopped serving our revision.
            v = payload.get("v")
            if v < (self._version(app_id) or 0):
                self.stale_have_demoted += 1
            changed = self._sync_peer_mask(app_id, peer, 0)
            rerouted = self._drop_peer_pending(app_id, peer)
            if (changed or rerouted) and app_id in self.fetching:
                self.pump(app_id)
            return
        if "peer" in payload:
            # relayed (extra hop, possibly stale): grow-only merge
            changed = self._note_peer_mask(app_id, peer,
                                           payload.get("mask", 0))
        else:
            # direct from the peer: authoritative snapshot — may shrink
            # (crash-restarted peers re-announce what they really hold)
            changed = self._sync_peer_mask(app_id, peer,
                                           payload.get("mask", 0))
        # requests outstanding at a peer that turns out to lack the piece
        # are re-routed right away
        pending = self.pending.get(app_id)
        rerouted = False
        if pending:
            known = self.peer_masks[app_id].get(peer, 0)
            for piece_id in [p for p, asked in pending.items()
                             if peer in asked and not (known >> p) & 1]:
                self._req_del(app_id, piece_id, peer)
                rerouted = True
        # a HAVE that changed nothing cannot change pump's decision either
        if (changed or rerouted) and app_id in self.fetching:
            self.pump(app_id)

    def on_interested(self, msg: Msg) -> None:
        app_id = msg.payload["app_id"]
        peer = msg.src
        self.swarm_peers[app_id].add(peer)
        if app_id not in self.manifests:
            return
        self.interested[app_id].add(peer)
        if not self.cfg.choke:
            # choking disabled: everyone is always welcome
            self.send(peer, Msg(UNCHOKE, self.node_id,
                                {"app_id": app_id}, size_bytes=64))
            return
        if peer in self.unchoked[app_id]:
            # the peer re-expressed interest while already holding a slot:
            # our earlier UNCHOKE was lost — repeat the grant (idempotent)
            self.send(peer, Msg(UNCHOKE, self.node_id,
                                {"app_id": app_id}, size_bytes=64))
            return
        self._maybe_unchoke_now(app_id)

    def _maybe_unchoke_now(self, app_id: str) -> None:
        """Fill free upload slots immediately (startup fast path); the
        periodic rechoke later re-ranks by reciprocal throughput."""
        unchoked = self.unchoked[app_id]
        for peer in sorted(self.interested[app_id] - unchoked):
            if len(unchoked) >= self.cfg.upload_slots:
                break
            self._unchoke(app_id, peer)

    def _unchoke(self, app_id: str, peer: str) -> None:
        if self.hub is not None and self.hub.grant(self, app_id, peer):
            return           # applied through the arrays, nothing on wire
        self.unchoked[app_id].add(peer)
        self.send(peer, Msg(UNCHOKE, self.node_id,
                            {"app_id": app_id}, size_bytes=64))
        queued = self.queued_reqs[app_id].pop(peer, None)
        if queued:
            for piece_id in sorted(queued):
                self._serve(app_id, peer, piece_id)

    def _choke(self, app_id: str, peer: str) -> None:
        if self.hub is not None and self.hub.choke(self, app_id, peer):
            return
        self.unchoked[app_id].discard(peer)
        self.send(peer, Msg(CHOKE, self.node_id,
                            {"app_id": app_id}, size_bytes=64))

    # --------------------- reciprocity accounting ----------------------- #
    def _credit_from(self, peer: str, nbytes: int) -> None:
        """Account verified piece payload received from `peer`."""
        self.bytes_from[peer] += nbytes
        est = self.rate_from.get(peer)
        if est is None:
            est = self.rate_from[peer] = RollingRate(self._rate_window)
        est.add(self.now(), nbytes)

    def _credit_to(self, peer: str, nbytes: int) -> None:
        """Account piece payload served to `peer`."""
        self.bytes_to[peer] += nbytes
        est = self.rate_to.get(peer)
        if est is None:
            est = self.rate_to[peer] = RollingRate(self._rate_window)
        est.add(self.now(), nbytes)

    def _rate(self, table: Dict[str, RollingRate], peer: str,
              now: float) -> float:
        est = table.get(peer)
        return est.rate(now) if est is not None else 0.0

    def rechoke(self) -> None:
        """Periodic re-choke: keep the best reciprocators (rolling-window
        byte rate received from the peer, then rate served to it — a
        seeder's proxy for the peer's drain rate) in the regular slots and
        rotate one optimistic unchoke through the rest so new peers can
        bootstrap.  Ranking on *rates* rather than lifetime totals means a
        historically fast but now-idle peer loses its slot within one
        window instead of dominating rechoke decisions forever."""
        if not self.cfg.choke:
            return
        if self.hub is not None:
            return           # the hub reranks every holder per tick batch
        self._rechoke_round += 1
        every = max(int(getattr(self.cfg, "optimistic_every", 3)), 1)
        rotate = self._rechoke_round % every == 0
        for app_id in list(self.interested):
            self._rechoke_app(app_id, rotate)

    def _rechoke_app(self, app_id: str, rotate: bool) -> None:
        cands = {p for p in self.interested[app_id] if p != self.node_id}
        slots = max(int(self.cfg.upload_slots), 1)
        if len(cands) <= slots:
            new = set(cands)
            self.opt_unchoked.pop(app_id, None)
        else:
            now = self.now()
            ranked = sorted(cands, key=lambda p: (
                -self._rate(self.rate_from, p, now),
                -self._rate(self.rate_to, p, now), p))
            new = set(ranked[:slots - 1])
            rest = sorted(cands - new)
            opt = self.opt_unchoked.get(app_id)
            if rotate or opt not in rest:
                self._opt_idx[app_id] += 1
                opt = rest[self._opt_idx[app_id] % len(rest)]
            self.opt_unchoked[app_id] = opt
            new.add(opt)
        old = self.unchoked.get(app_id, set())
        for peer in sorted(old - new):
            self._choke(app_id, peer)
        for peer in sorted(new - old):
            self._unchoke(app_id, peer)

    def on_choke(self, msg: Msg) -> None:
        app_id = msg.payload["app_id"]
        peer = msg.src
        self.unchoked_by[app_id].discard(peer)
        # re-route outstanding requests parked at the choking holder
        self._route_choked(app_id, peer)
        if app_id in self.fetching:
            self.pump(app_id)

    def on_unchoke(self, msg: Msg) -> None:
        app_id = msg.payload["app_id"]
        self.unchoked_by[app_id].add(msg.src)
        if app_id in self.fetching:
            self.pump(app_id)

    def on_piece_cancel(self, msg: Msg) -> None:
        app_id = msg.payload["app_id"]
        queued = self.queued_reqs.get(app_id, {}).get(msg.src)
        if queued is not None:
            queued.discard(msg.payload["piece_id"])
            if not queued:
                self.queued_reqs[app_id].pop(msg.src, None)

    def on_piece_req(self, msg: Msg) -> None:
        app_id = msg.payload["app_id"]
        piece_id = msg.payload["piece_id"]
        peer = msg.src
        self.swarm_peers[app_id].add(peer)
        manifest = self.manifests.get(app_id)
        inv = self.inventories.get(app_id)
        if self._stale_version(app_id, msg.payload.get("v")):
            # never serve across revisions: our pieces would verify against
            # a different manifest (or worse, collide on unchanged ids and
            # smuggle stale content in as fresh).  The HAVE reply carries
            # our version, so the requester demotes us from its pool.
            self.stale_reqs_refused += 1
            self.send(peer, self._have_msg(app_id))
            return
        holds = (app_id in self.complete
                 or (inv is not None and inv.has(piece_id)))
        if manifest is None or not holds:
            # tell the requester what we actually have so it re-routes
            self.send(peer, self._have_msg(app_id))
            return
        self.interested[app_id].add(peer)       # a request implies interest
        if self.cfg.choke and peer not in self.unchoked[app_id]:
            self._maybe_unchoke_now(app_id)
        if self.cfg.choke and peer not in self.unchoked[app_id]:
            if msg.payload.get("endgame"):
                # endgame duplicates wait for a slot instead of bouncing;
                # PIECE_CANCEL prunes them if another holder wins the race
                self.queued_reqs[app_id].setdefault(peer, set()).add(piece_id)
            else:
                self._choke(app_id, peer)
            return
        self._serve(app_id, peer, piece_id)

    def _piece_payload(self, app_id: str, piece_id: int):
        """The piece's payload as a zero-copy view over the shared image
        buffer (or the stored/cached slice for partial holders)."""
        image = self.image_src.get(app_id)
        if image is not None:
            manifest = self.manifests[app_id]
            lo = piece_id * manifest.piece_bytes
            return image[lo:lo + manifest.piece_bytes]
        data = self.store.get(app_id, {}).get(piece_id)
        if data is None and self.dirs is not None:
            data = self.dirs.load_piece(app_id, piece_id)
        return data

    def _serve(self, app_id: str, peer: str, piece_id: int) -> None:
        manifest = self.manifests[app_id]
        mask = self.bitfield_mask(app_id)
        payload = {"app_id": app_id, "piece_id": piece_id,
                   "proof": manifest.piece_hashes[piece_id], "mask": mask,
                   "v": manifest.version}
        data = self._piece_payload(app_id, piece_id)
        if data is not None:
            payload["data"] = data
        self._credit_to(peer, manifest.piece_size(piece_id))
        if self.hub is not None:
            self.hub.credit(self, app_id, peer,
                            manifest.piece_size(piece_id), received=False)
        self.send(peer, Msg(PIECE_DATA, self.node_id, payload,
                            size_bytes=96 + manifest.piece_size(piece_id)
                            + mask_nbytes(mask)))

    def on_piece_data(self, msg: Msg) -> None:
        app_id = msg.payload["app_id"]
        piece_id = msg.payload["piece_id"]
        peer = msg.src
        self.swarm_peers[app_id].add(peer)
        if self._stale_version(app_id, msg.payload.get("v")):
            # a payload for a different manifest revision: DISCARD, do not
            # verify, do not merge the attached mask.  This is NOT a ban —
            # the peer is an honest holder of the other revision (e.g. a
            # v1 seeder answering a request issued before our upgrade);
            # banning it would lose it for good once it upgrades too.
            self.stale_piece_data += 1
            if msg.payload.get("v", 0) < (self._version(app_id) or 0):
                self._sync_peer_mask(app_id, peer, 0)
            self._drop_peer_pending(app_id, peer)
            if app_id in self.fetching:
                self.pump(app_id)
            return
        self._note_peer_mask(app_id, peer, msg.payload.get("mask"))
        # answered: drop the in-flight entry (when it was the last holder
        # the piece re-enters `missing`, so a corrupt reply cannot stall
        # it until recover())
        self._req_del(app_id, piece_id, peer)
        inv = self.inventories.get(app_id)
        if inv is None or inv.complete or inv.has(piece_id):
            if inv is not None:
                self.dup_piece_data += 1     # endgame race lost by `peer`
            self._reconcile(app_id, piece_id)
            return
        data = msg.payload.get("data")
        if not inv.add(piece_id, msg.payload.get("proof"), data=data):
            # corrupt piece: never ask this peer again, fetch elsewhere
            self._ban(app_id, peer)
            self.unchoked_by[app_id].discard(peer)
            self.pump(app_id)
            return
        if self._stale_version(app_id, msg.payload.get("v")):
            # unreachable while the discard gate above holds; evaluated
            # again at the accept site so any future bypass of that gate
            # trips the chaos suites' stale_accepts == 0 assertion
            self.stale_accepts += 1
        manifest = inv.manifest
        nbytes = manifest.piece_size(piece_id)
        self._credit_from(peer, nbytes)
        if self.hub is not None:
            self.hub.credit(self, app_id, peer, nbytes, received=True)
        self.pieces_from[app_id][peer] += 1
        if data is not None:
            self.store[app_id][piece_id] = data
            if self.dirs is not None:
                self.dirs.save_piece(app_id, piece_id, data)
        if self.on_bytes is not None:
            self.on_bytes(app_id, nbytes)
        # endgame reconciliation: the race is decided, cancel the rest
        self._reconcile(app_id, piece_id)
        if self.hub is not None:
            # hub mode: one array write replaces the whole announce
            # fan-out (the hub counts the suppressed deliveries)
            self.hub.note_have(self, app_id, piece_id)
            if inv.complete:
                self._complete_fetch(app_id)
            return
        # announce to known peers directly AND via the tracker relay.  The
        # relay alone would suffice for reach, but the extra hop delays
        # rarity information enough to push measurably more piece traffic
        # back onto the origin; the ~bitmask-sized announces are cheap next
        # to the pieces they steer.  One Msg serves the whole burst — the
        # payload is identical for every target (receivers treat payloads
        # as read-only, like the tracker's relays).
        announce = self._have_msg(app_id)
        for target in sorted(self.swarm_peers[app_id] - {peer,
                                                         self.node_id}):
            self.send(target, announce)
        self.send(self.tracker_id, announce)
        if inv.complete:
            self._complete_fetch(app_id)
        else:
            self.pump(app_id)

    def _reconcile(self, app_id: str, piece_id: int) -> None:
        """Drop the pending entry for a piece we now hold and PIECE_CANCEL
        every other holder still racing to serve it."""
        stalled = self.stalled_holders.get(app_id)
        if stalled:
            stalled.pop(piece_id, None)      # decided: forget stale history
        if self.hub is not None:
            self.hub.mark_dirty(self, app_id)
        asked = self._req_clear(app_id, piece_id)
        if not asked:
            return
        for holder in sorted(asked):
            self.cancels_sent += 1
            self.send(holder, Msg(PIECE_CANCEL, self.node_id,
                                  {"app_id": app_id, "piece_id": piece_id},
                                  size_bytes=64))

    def _complete_fetch(self, app_id: str) -> None:
        """All pieces verified: reassemble real images, cache the Seed
        copy, and hand the agent the keys to the executable.  Real images
        are interned by manifest hash so every replica in a simulation
        shares one buffer instead of materialising its own copy."""
        inv = self.inventories[app_id]
        self.complete.add(app_id)
        self.fetching.discard(app_id)
        for piece_id in list(self.pending.get(app_id, {})):
            self._reconcile(app_id, piece_id)
        if self.hub is not None:
            self.hub.set_full(self, app_id)
        image = None
        if inv.manifest.content_hashed:
            mh = inv.manifest.manifest_hash
            image = acquire_image(mh)
            if image is None:
                assembled = self.assembled_image(app_id)  # store or disk
                if assembled is not None:
                    image = intern_image(mh, assembled)
            if image is not None:
                self._track_intern(app_id, mh)
                self.image_src[app_id] = memoryview(image)
                # the shared image supersedes the per-piece slices
                self.store.pop(app_id, None)
                if self.dirs is not None:
                    self.dirs.save_seed_image(app_id, image)
        if self.on_image_complete is not None:
            self.on_image_complete(app_id, inv.manifest.manifest_hash, image)

    # ========================== maintenance ============================= #
    def recover(self, app_id: str, stall_s: float) -> None:
        """Re-issue piece requests that went unanswered (e.g. the holder
        died before PEER_GONE propagated, or never unchoked us)."""
        now = self.now()
        pending = self.pending.get(app_id, {})
        for piece_id, asked in list(pending.items()):
            stale = [peer for peer, t in asked.items() if now - t > stall_s]
            for peer in stale:
                self._req_del(app_id, piece_id, peer)
                # shun the silent holder for this piece so the
                # re-request pump issues goes to an alternate one
                self.stalled_holders.setdefault(app_id, {}) \
                    .setdefault(piece_id, set()).add(peer)
                # the holder may have the request parked in its choke
                # queue (endgame): withdraw it, or it inflates the
                # load the holder reports to the tracker forever
                self.send(peer, Msg(PIECE_CANCEL, self.node_id,
                                    {"app_id": app_id,
                                     "piece_id": piece_id},
                                    size_bytes=64))
        # allow a fresh INTERESTED round toward holders that never answered
        if (self.hub is None and app_id in self.fetching
                and not self.unchoked_by[app_id]):
            self.interest_sent[app_id].clear()
            self._interest_clean.discard(app_id)
            # re-announce to the tracker: with no holder granting us a
            # slot, our join HAVE (or the tracker's relays) may have been
            # lost — without the announce the swarm never discovers us
            self.send(self.tracker_id, self._have_msg(app_id))
        self.pump(app_id)
