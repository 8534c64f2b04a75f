"""Array-native swarm state + the batched per-tick decision engine.

`PieceExchange` (core/piece_exchange.py) makes every scheduling decision
one Python call at a time — a pump per HAVE announce, a choke pass per
holder, one heap event per protocol message.  That per-message dispatch
caps practical swarm sizes near N=200 (ROADMAP: "N=2000+ flash crowds
via batched, array-native simulation").  This module is the batched
counterpart:

  * `SwarmState` — one app's swarm as flat numpy arrays over *rows*
    (nodes): peer x piece `have` bitmask matrix, per-piece availability
    `counts`, full-seeder / fetching flags, and an
    array-native IN-FLIGHT REQUEST LEDGER plus sparse choke/rate
    structures that replace the former dense (cap, cap) matrices:

      - ledger: `pend_holder[node, piece, slot]` (holder row, -1 empty,
        -2 for holders without a hub row), `pend_t` (request timestamps,
        the deadline basis), `pend_cnt[node, piece]`, `pend_n[node]`
        (pieces in flight, the budget counter), and a compact
        `busy_rows[node, :busy_n]` list of holder rows with a request in
        flight (one in-flight request per holder).  Updated
        *incrementally* on PIECE_REQ / DATA / CANCEL via the
        `ledger_add/del/clear/drop` hooks `PieceExchange._req_*` fire.
      - unchoke graph: dual adjacency lists `uc_rows[h, :uc_n]` (rows
        holder h grants) and `ub_rows[l, :ub_n]` (rows granting leecher
        l) instead of a dense bool matrix — at N=10,000 the matrix alone
        would be 268 MB and its four float32 rate companions 4.3 GB.
      - rates: per-holder sparse edge dicts `edges[h][peer] ->
        [recv_cur, recv_prev, sent_cur, sent_prev]` (float32 scalar
        arithmetic, bit-identical to the old float32 matrix
        accumulation), tumbled and pruned on window expiry.

  * `SwarmHub` — the per-tick engine.  Agents' `PieceExchange` instances
    register with the hub (hub mode); verified pieces, completions and
    request-ledger changes are mirrored into the arrays, and once per
    simulation tick the hub runs the whole swarm's decisions as batched
    array passes using the `swarm_kernels` functions on the hub's device
    (the Hopper kernels on "cuda", their plain PyTorch versions on
    "cpu"):

      1. slot release   — upload slots held by newly-completed leechers
                          are freed (the batched `_promote_full_seeder`);
      2. grants         — event-driven agenda of holders whose free-slot
                          or candidate set changed unchoke the
                          lowest-named interested leechers;
      3. rechoke        — every `rechoke_interval_s` of sim time, all
                          holders re-rank candidates by reciprocal
                          transfer rates in ONE `choke_order` kernel
                          call over per-holder shortlists (rate edges +
                          a rank-ordered zero-rate fill that provably
                          contains the true top slots-1), with the
                          scalar engine's deterministic
                          optimistic-unchoke rotation;
      4. pump           — piece orders from ONE `rarest_orders` kernel
                          call; holder matching for ALL rows in ONE
                          fused `match_requests_ragged` kernel call that
                          walks order positions (<= P steps independent
                          of N) over each row's own candidates (CSR),
                          taken straight from the unchoke adjacency and
                          the busy ledger;
      5. endgame        — rows whose every missing piece is in flight
                          (pure ledger-counter selection) duplicate
                          requests to the per-piece `holder_topk`
                          shortlist with vectorized exclusion of
                          already-asked holders.

    Rows with shunned or banned holders fall back per-row to the scalar
    `_match_row` walk, which still reads the `px.pending` dicts — those
    dicts remain maintained and serve as the DIFFERENTIAL REFERENCE the
    ledger is tested entry-for-entry against (tests/test_swarm_batch.py).

The *decisions* are the scalar engine's, bit for bit where the
information sets coincide.  What changes is the *information flow*: the
shared arrays stand in for the HAVE announce fan-out, INTERESTED
declarations, and UNCHOKE/CHOKE notifications, which in hub mode are
applied directly instead of being delivered as O(N^2) wire messages.
Piece traffic itself (PIECE_REQ / PIECE_DATA / PIECE_CANCEL) stays on
the simulated wire — link serialization, faults, chaos hooks and
partitions still apply to every byte moved.  Approximations are
documented in docs/torrent_protocol.md: control-plane updates have zero
latency (and ignore partitions), choke ranking reads two-bucket
tumbling-window rates instead of the scalar deque estimator, and the
fused endgame emits duplicates in ascending piece-id order rather than
pending-dict insertion order (same duplicate SET, different wire order).

Where the state lives.  Host bookkeeping (ledger, adjacency, rate edges,
ranks, counters) stays in numpy, because the per-event hooks write a few
scalars at a time and scalar writes into device memory would cost a
launch or a sync each.  What the kernels read — `have`, `full`, `alive`
and `island` — is mirrored into device planes (`have_d`, `full_d`,
`alive_d`, `island_d`).  The hooks that write those host arrays add the
row to `plane_dirty`, and `sync_planes` brings the planes up to date with
one indexed copy per plane at the top of every tick.  One pump then stays
on the device from keys to picks: the missing mask goes up once, the
piece orders are computed there, the matcher reads them and the planes
there, and only orders and picks come back.

Every suppressed control message is counted in `coalesced`, every
array-applied decision in `batch_ops`, and every incremental ledger
update in `ledger_ops`; `tick()` also keeps wall-clock totals split into
host-Python and kernel time for a per-tick profile breakdown.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core.swarm_kernels import (KEY_INF32, choke_order,
                                            cost_orders, holder_topk,
                                            island_cost_rows,
                                            match_requests_ragged,
                                            rarest_orders)

_DEVICE_TYPES = ("cuda", "cpu")


def resolve_device(device="cuda") -> torch.device:
    """The hub's device: "cuda" (the default, the Hopper kernels) or
    "cpu" (the plain PyTorch versions).  Anything else raises, and so does
    "cuda" on a machine without a CUDA device — there is no silent
    fallback to the CPU."""
    dev = torch.device(device)
    if dev.type not in _DEVICE_TYPES:
        raise ValueError(f"unsupported device {device!r}: expected one of "
                         f"{_DEVICE_TYPES}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch finds no CUDA "
                           "device; pass device='cpu' for the plain "
                           "PyTorch path")
    return dev

# holder-key layout under topology (P4P): rank fills the low 31 bits,
# the ALTO cost (<= COST_NONE = 64) sits above it, and the shun bit sits
# above the cost — so shunned holders lose to ANY live holder however
# expensive (the bias-decays-under-starvation property)
_COST_SHIFT = np.int64(2 ** 32)
_SHUN_INF = np.int64(2 ** 45)
# the choke-ranking / fused-matching tie-break must fit the matcher
# kernel's int32 holder keys: row ranks are < 2^20 for any simulable swarm,
# costs <= 64, so cost * 2^20 + rank < 2^27.  This orders identically
# to the scalar engine's rank + cost * 2^32 — both are the
# lexicographic (cost, rank) order, since rank < 2^20.
_CHOKE_COST_SHIFT = np.int64(2 ** 20)


class SwarmState:
    """One app's swarm as flat arrays; rows are nodes (stable ids)."""

    # per-row buffers grown together in ONE pass (there are no dense
    # (cap, cap) choke/rate matrices: everything is O(rows) and
    # reallocated exactly once per growth)
    _ROW_FILL = {"opt_peer": -1, "pend_holder": -1, "uc_rows": -1,
                 "ub_rows": -1, "busy_rows": -1}
    _ROW_ARRAYS = ("have", "have_n", "full", "fetching", "alive",
                   "offsets", "_ranks", "starved", "opt_idx", "opt_peer",
                   "island", "pend_holder", "pend_t", "pend_cnt",
                   "pend_n", "pipeline", "eg_cap", "busy_rows", "busy_n",
                   "uc_rows", "uc_n", "ub_rows", "ub_n")
    # device planes the kernels read, grown in the same pass: plane ->
    # the host array it mirrors
    _PLANES = {"have_d": "have", "full_d": "full", "alive_d": "alive",
               "island_d": "island"}

    def __init__(self, app_id: str, manifest, capacity: int = 64,
                 dup_slots: int = 4, device="cuda"):
        self.app_id = app_id
        self.device = resolve_device(device)
        self.manifest = manifest
        self.P = int(manifest.n_pieces)
        cap = max(int(capacity), 4)
        self.names: List[str] = []
        self.row: Dict[str, int] = {}
        self.clients: List[Optional[object]] = []   # row -> PieceExchange
        self.n = 0                                  # rows in use
        self.n_alive = 0
        # --- holdings ----------------------------------------------------- #
        self.have = np.zeros((cap, self.P), dtype=bool)
        self.counts = np.zeros(self.P, dtype=np.int32)
        self.have_n = np.zeros(cap, dtype=np.int32)
        self.full = np.zeros(cap, dtype=bool)
        self.fetching = np.zeros(cap, dtype=bool)
        self.alive = np.zeros(cap, dtype=bool)
        # --- in-flight request ledger ------------------------------------- #
        # pend_holder[i, p, s]: holder row of in-flight request slot s
        # (-1 empty, -2 = holder has no hub row); pend_t the request
        # timestamp (deadline basis); slots [0:pend_cnt) are compact
        d = max(int(dup_slots), 1)
        self.pend_holder = np.full((cap, self.P, d), -1, dtype=np.int32)
        self.pend_t = np.zeros((cap, self.P, d), dtype=np.float64)
        self.pend_cnt = np.zeros((cap, self.P), dtype=np.int16)
        self.pend_n = np.zeros(cap, dtype=np.int32)       # pieces in flight
        self.pipeline = np.zeros(cap, dtype=np.int32)     # per-row budget cap
        self.eg_cap = np.ones(cap, dtype=np.int16)        # per-row endgame dup
        # busy_rows[i, :busy_n]: holder rows with a request of i's in
        # flight (one request per holder — the matcher's exclusion list)
        self.busy_rows = np.full((cap, 4 * d), -1, dtype=np.int32)
        self.busy_n = np.zeros(cap, dtype=np.int16)
        # --- choke / link state (sparse) ---------------------------------- #
        # dual adjacency: uc_rows[h, :uc_n[h]] = leecher rows holder h
        # grants (bounded ~ upload_slots + 1); ub_rows[l, :ub_n[l]] =
        # holder rows granting leecher l (unbounded; width doubles)
        self.uc_rows = np.full((cap, 8), -1, dtype=np.int32)
        self.uc_n = np.zeros(cap, dtype=np.int32)
        self.ub_rows = np.full((cap, 8), -1, dtype=np.int32)
        self.ub_n = np.zeros(cap, dtype=np.int32)
        # rolling two-bucket transfer-byte windows as sparse edges:
        # edges[h][peer] = [recv_cur, recv_prev, sent_cur, sent_prev]
        # (float32 scalars — bit-identical to the old matrix += path)
        self.edges: List[Dict[int, List[np.float32]]] = []
        self.win_start = 0.0
        # optimistic-unchoke rotation (scalar `_opt_idx`/`opt_unchoked`)
        self.opt_idx = np.zeros(cap, dtype=np.int64)
        self.opt_peer = np.full(cap, -1, dtype=np.int32)
        # --- selection tie-breaks ----------------------------------------- #
        # per-node rarest-first rotation: sum(ord(c) for c in name+app_id)
        self.offsets = np.zeros(cap, dtype=np.int64)
        self._ranks = np.zeros(cap, dtype=np.int64)
        self._ranks_dirty = True
        # --- topology (P4P) ------------------------------------------------ #
        self.island = np.zeros(cap, dtype=np.int32)
        self.lookup_island = None
        # --- device planes (see the module docstring) ---------------------- #
        dev = self.device
        self.have_d = torch.zeros((cap, self.P), dtype=torch.uint8,
                                  device=dev)
        self.full_d = torch.zeros(cap, dtype=torch.uint8, device=dev)
        self.alive_d = torch.zeros(cap, dtype=torch.uint8, device=dev)
        self.island_d = torch.zeros(cap, dtype=torch.int64, device=dev)
        self.plane_dirty: Set[int] = set()   # rows changed since the sync
        # --- scheduling bookkeeping --------------------------------------- #
        self.dirty: Set[int] = set()       # rows to re-pump this tick
        self.starved = np.zeros(cap, dtype=bool)
        self.avail_epoch = 0               # bumped on any availability change
        self.pump_epoch = -1               # avail_epoch at the last pump pass
        self.newly_full: List[int] = []    # rows completed since last tick
        self.last_rechoke = 0.0
        self.rechoke_round = 0
        # event-driven grant agenda: holders whose free-slot or
        # candidate view changed since the last pass; grant_scan forces
        # a full holder sweep (new fetching rows make EVERY free-slot
        # holder relevant again)
        self.grant_agenda: Set[int] = set()
        self.grant_scan = True

    # ------------------------------ rows -------------------------------- #
    def _grow(self, need: int) -> None:
        cap = self.have.shape[0]
        new = cap
        while new < need:
            new *= 2
        for name in self._ROW_ARRAYS:
            a = getattr(self, name)
            fill = self._ROW_FILL.get(name, 0)
            b = np.full((new,) + a.shape[1:], fill, dtype=a.dtype)
            b[:cap] = a
            setattr(self, name, b)
        for name in self._PLANES:
            a = getattr(self, name)
            b = torch.zeros((new,) + tuple(a.shape[1:]), dtype=a.dtype,
                            device=a.device)
            b[:cap] = a
            setattr(self, name, b)

    def touch(self, i: int) -> None:
        """Row i's have/full/alive/island changed on the host: copy it to
        the device planes at the next `sync_planes`."""
        self.plane_dirty.add(i)

    def sync_planes(self) -> None:
        """Bring the device planes up to date: one indexed copy per plane
        over the rows touched since the last sync."""
        if not self.plane_dirty:
            return
        rows = np.fromiter(sorted(self.plane_dirty), dtype=np.int64,
                           count=len(self.plane_dirty))
        self.plane_dirty.clear()
        idx = torch.from_numpy(rows).to(self.device)
        for plane, host in self._PLANES.items():
            src = torch.from_numpy(getattr(self, host)[rows])
            dst = getattr(self, plane)
            dst.index_copy_(0, idx, src.to(device=self.device,
                                           dtype=dst.dtype))

    def _grow_cols(self, name: str, need: int, fill: int = -1) -> None:
        """Double the trailing (width) dimension of one list-shaped
        buffer until it holds `need` entries."""
        a = getattr(self, name)
        w = max(a.shape[-1], 1)
        while w < need:
            w *= 2
        if w == a.shape[-1]:
            return
        b = np.full(a.shape[:-1] + (w,), fill, dtype=a.dtype)
        b[..., : a.shape[-1]] = a
        setattr(self, name, b)

    def _grow_dups(self, need: int) -> None:
        self._grow_cols("pend_holder", need, fill=-1)
        self._grow_cols("pend_t", need, fill=0)

    def ensure_row(self, name: str) -> int:
        """Row id for a node, allocating (and growing) on first sight."""
        i = self.row.get(name)
        if i is not None:
            return i
        i = self.n
        if i >= self.have.shape[0]:
            self._grow(i + 1)
        self.row[name] = i
        self.names.append(name)
        self.clients.append(None)
        self.edges.append({})
        self.n += 1
        self.alive[i] = True
        self.n_alive += 1
        self.offsets[i] = sum(ord(c) for c in name + self.app_id)
        if self.lookup_island is not None:
            self.island[i] = self.lookup_island(name)
        self.touch(i)
        self._ranks_dirty = True
        return i

    @property
    def ranks(self) -> np.ndarray:
        """Column -> lexicographic rank of the node name: what the scalar
        engine's string tie-breaks (`min(..., h)`, `sorted(...)`) sort
        by, as an integer the kernels can compare."""
        if self._ranks_dirty:
            order = sorted(range(self.n), key=self.names.__getitem__)
            for rank, i in enumerate(order):
                self._ranks[i] = rank
            self._ranks_dirty = False
        return self._ranks

    def holder_mask(self) -> np.ndarray:
        """(n,) bool: rows currently holding at least one piece."""
        n = self.n
        return ((self.have_n[:n] > 0) | self.full[:n]) & self.alive[:n]

    # --------------------- unchoke adjacency ---------------------------- #
    def uc_set(self, h: int) -> Set[int]:
        """Rows holder h currently grants (the old matrix row)."""
        return set(self.uc_rows[h, : self.uc_n[h]].tolist())

    def unchoked_matrix(self) -> np.ndarray:
        """Dense (n, n) unchoke matrix rebuilt from the adjacency —
        test/debug helper only; the engine never materializes it."""
        m = np.zeros((self.n, self.n), dtype=bool)
        for h in range(self.n):
            k = int(self.uc_n[h])
            if k:
                m[h, self.uc_rows[h, :k]] = True
        return m

    def _link(self, h: int, l: int) -> bool:
        """Add the h-grants-l edge to both adjacency sides (idempotent).
        Returns False when the edge already existed.  Segments are a
        handful of entries (bounded by upload_slots on the uc side), so
        the membership scans run as plain Python loops — numpy slice +
        any()/nonzero() overhead dominates actual work at these sizes."""
        uc, k = self.uc_rows[h], int(self.uc_n[h])
        for c in range(k):
            if uc[c] == l:
                return False
        if k >= self.uc_rows.shape[1]:
            self._grow_cols("uc_rows", k + 1)
        self.uc_rows[h, k] = l
        self.uc_n[h] = k + 1
        k = int(self.ub_n[l])
        if k >= self.ub_rows.shape[1]:
            self._grow_cols("ub_rows", k + 1)
        self.ub_rows[l, k] = h
        self.ub_n[l] = k + 1
        return True

    def _unlink(self, h: int, l: int) -> bool:
        """Remove the h-grants-l edge (swap-remove both sides)."""
        uc, k = self.uc_rows[h], int(self.uc_n[h])
        for c in range(k):
            if uc[c] == l:
                uc[c] = uc[k - 1]
                uc[k - 1] = -1
                self.uc_n[h] = k - 1
                break
        else:
            return False
        # the ub side is unbounded (popular leechers are granted by many
        # holders): scan small segments in Python, big ones vectorized
        ub, k = self.ub_rows[l], int(self.ub_n[l])
        if k <= 32:
            for c in range(k):
                if ub[c] == h:
                    ub[c] = ub[k - 1]
                    ub[k - 1] = -1
                    self.ub_n[l] = k - 1
                    break
        else:
            hit = np.nonzero(ub[:k] == h)[0]
            if hit.size:
                c = int(hit[0])
                ub[c] = ub[k - 1]
                ub[k - 1] = -1
                self.ub_n[l] = k - 1
        return True

    # ------------------------- request ledger --------------------------- #
    def ledger_add_row(self, i: int, piece_id: int, j: int,
                       t: float) -> None:
        """Record an in-flight request: row i asked holder row j (-2 when
        the holder has no hub row) for `piece_id` at time t."""
        d = int(self.pend_cnt[i, piece_id])
        if d >= self.pend_holder.shape[2]:
            self._grow_dups(d + 1)
        if d == 0:
            self.pend_n[i] += 1
        self.pend_holder[i, piece_id, d] = j
        self.pend_t[i, piece_id, d] = t
        self.pend_cnt[i, piece_id] = d + 1
        if j >= 0:
            b = int(self.busy_n[i])
            if b >= self.busy_rows.shape[1]:
                self._grow_cols("busy_rows", b + 1)
            self.busy_rows[i, b] = j
            self.busy_n[i] = b + 1

    def _busy_del(self, i: int, j: int) -> None:
        b = int(self.busy_n[i])
        seg = self.busy_rows[i, :b]
        hit = np.nonzero(seg == j)[0]
        if hit.size:
            k = int(hit[0])
            self.busy_rows[i, k] = self.busy_rows[i, b - 1]
            self.busy_rows[i, b - 1] = -1
            self.busy_n[i] = b - 1

    def ledger_del_row(self, i: int, piece_id: int, j: int) -> None:
        """Drop one in-flight entry (answered, cancelled or re-routed).
        Tolerates a holder that registered after the request was issued
        as -2 (falls back to removing a -2 slot)."""
        d = int(self.pend_cnt[i, piece_id])
        if d == 0:
            return
        slots = self.pend_holder[i, piece_id, :d]
        hit = np.nonzero(slots == j)[0]
        if hit.size == 0 and j >= 0:
            hit = np.nonzero(slots == -2)[0]
            j = -2
        if hit.size == 0:
            return
        k = int(hit[0])
        self.pend_holder[i, piece_id, k] = self.pend_holder[i, piece_id,
                                                            d - 1]
        self.pend_t[i, piece_id, k] = self.pend_t[i, piece_id, d - 1]
        self.pend_holder[i, piece_id, d - 1] = -1
        self.pend_t[i, piece_id, d - 1] = 0.0
        self.pend_cnt[i, piece_id] = d - 1
        if d == 1:
            self.pend_n[i] -= 1
        if j >= 0:
            self._busy_del(i, j)

    def ledger_clear_row(self, i: int, piece_id: int) -> None:
        """Drop every in-flight entry for one piece (reconcile path)."""
        d = int(self.pend_cnt[i, piece_id])
        if d == 0:
            return
        for s in range(d):
            j = int(self.pend_holder[i, piece_id, s])
            if j >= 0:
                self._busy_del(i, j)
        self.pend_holder[i, piece_id, :d] = -1
        self.pend_t[i, piece_id, :d] = 0.0
        self.pend_cnt[i, piece_id] = 0
        self.pend_n[i] -= 1

    def ledger_drop_row(self, i: int) -> None:
        """Wipe row i's whole ledger (app dropped / row reset)."""
        self.pend_holder[i] = -1
        self.pend_t[i] = 0.0
        self.pend_cnt[i] = 0
        self.pend_n[i] = 0
        self.busy_rows[i] = -1
        self.busy_n[i] = 0


def load_state_arrays(st: SwarmState, arrays: Dict[str, np.ndarray]) -> None:
    """Fill `st` (host arrays and device planes) from a plain-numpy
    snapshot of a swarm state: every name of `SwarmState._ROW_ARRAYS`
    plus ``counts``, ``names`` and ``P``.  The rows come without engines
    (`clients` are None), so the snapshot serves pure decision queries:
    piece orders and fused holder matching from the same state."""
    if int(arrays["P"]) != st.P:
        raise ValueError(f"snapshot has P={int(arrays['P'])}, "
                         f"state has P={st.P}")
    names = [str(x) for x in arrays["names"]]
    for name in SwarmState._ROW_ARRAYS:
        a = np.asarray(arrays[name])
        setattr(st, name, a.astype(getattr(st, name).dtype, copy=True))
    cap = st.have.shape[0]
    st.counts = np.asarray(arrays["counts"]).astype(np.int32, copy=True)
    st.names = names
    st.row = {name: i for i, name in enumerate(names)}
    st.n = len(names)
    st.clients = [None] * st.n
    st.edges = [{} for _ in range(st.n)]
    st.n_alive = int(st.alive[: st.n].sum())
    st._ranks_dirty = True
    for plane, host in SwarmState._PLANES.items():
        setattr(st, plane, torch.zeros(
            (cap,) + getattr(st, plane).shape[1:],
            dtype=getattr(st, plane).dtype, device=st.device))
    st.plane_dirty = set(range(cap))
    st.sync_planes()


class SwarmHub:
    """Shared array state + batched per-tick decisions for all swarms.

    One hub serves a whole simulation; `PieceExchange` instances attach
    per app via `register_seed` / `register_leech` and mirror their
    verified-piece / request-ledger changes in.  `tick(now)` (driven by
    `SimRuntime.run_batched`) then computes every node's grants, chokes,
    piece requests and endgame duplicates in batched array passes.
    """

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        # keyed by (app_id, manifest version): revisions of one app are
        # DISJOINT swarms — a v(k) engine can neither read nor write
        # v(k+1) masks, so mixed-version flash crowds never cross
        self.states: Dict[Tuple[str, int], SwarmState] = {}
        self._cfg = None                   # choke parameters (first client)
        self.batch_ops = 0                 # array-applied decisions
        self.coalesced = 0                 # control messages replaced
        self.ledger_ops = 0                # incremental ledger updates
        self.ticks = 0
        # per-tick wall-clock split (profile breakdown)
        self.prof_tick_s = 0.0             # total time inside tick()
        self.prof_kernel_s = 0.0           # time inside kernel calls
        # topology (P4P mode): ALTO cost matrix folded into selection
        self.topology = None
        self.cost_matrix: Optional[np.ndarray] = None
        self.cost_matrix_d: Optional[torch.Tensor] = None
        # the matcher's int32 staging: pinned on the host and one device
        # copy per pump (grown to a power of two as needed)
        self._stage_h: Optional[torch.Tensor] = None
        self._stage_d: Optional[torch.Tensor] = None

    def _up(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> tensor on the hub's device."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _kernel(self, fn, *args, **kw) -> Tuple[torch.Tensor, np.ndarray]:
        """Run one kernel call under the profile clock; returns the result
        on the device and its host copy.  A CUDA launch returns before the
        card has run it, so the timed region ends with the device-to-host
        copy of the result: the clock measures finished work, not the
        launch."""
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        host = out.cpu().numpy()
        self.prof_kernel_s += time.perf_counter() - t0
        return out, host

    # ========================= registration ============================= #
    def set_topology(self, topology) -> None:
        """Enable P4P selection: piece orders and holder tie-breaks fold
        in the topology's ALTO cost map.  `None` restores pure rarity
        (the no-topology decisions, bit for bit)."""
        self.topology = topology
        if topology is None:
            self.cost_matrix = None
            self.cost_matrix_d = None
            for st in self.states.values():
                st.lookup_island = None
                st.island[:] = 0
                st.plane_dirty.update(range(st.n))
            return
        self.cost_matrix = np.asarray(topology.cost_map(), dtype=np.int64)
        self.cost_matrix_d = self._up(self.cost_matrix)
        for st in self.states.values():
            st.lookup_island = topology.island_of
            for i, name in enumerate(st.names):
                st.island[i] = topology.island_of(name)
                st.touch(i)

    @staticmethod
    def _key(app_id: str, manifest) -> Tuple[str, int]:
        return (app_id, int(getattr(manifest, "version", 1) or 1))

    def _state(self, app_id: str, manifest) -> SwarmState:
        key = self._key(app_id, manifest)
        st = self.states.get(key)
        if st is None:
            dup = 4
            if self._cfg is not None:
                dup = max(int(getattr(self._cfg, "endgame_dup", 3)), 1) + 1
            st = self.states[key] = SwarmState(app_id, manifest,
                                               dup_slots=dup,
                                               device=self.device)
            if self.topology is not None:
                st.lookup_island = self.topology.island_of
        return st

    def _lookup(self, px, app_id: str) -> Optional[SwarmState]:
        """The state for `px`'s CURRENT revision of `app_id` (None when
        the engine has no manifest or never attached)."""
        m = px.manifests.get(app_id)
        if m is None:
            return None
        return self.states.get(self._key(app_id, m))

    def _attach(self, px, app_id: str, manifest) -> Tuple[SwarmState, int]:
        if self._cfg is None:
            self._cfg = px.cfg
        st = self._state(app_id, manifest)
        i = st.ensure_row(px.node_id)
        if st.clients[i] is not None and st.clients[i] is not px:
            # same name, new incarnation (crash + restart): the fresh
            # engine starts empty — wipe the row before re-use
            self._reset_row(st, i)
        if not st.alive[i]:
            st.alive[i] = True
            st.n_alive += 1
        st.touch(i)
        st.clients[i] = px
        # per-row scheduling parameters the fused passes read in bulk
        st.pipeline[i] = int(px.cfg.piece_pipeline)
        cap = max(int(getattr(px.cfg, "endgame_dup", 3)), 1)
        st.eg_cap[i] = cap
        if cap > st.pend_holder.shape[2]:
            st._grow_dups(cap)
        return st, i

    def register_seed(self, px, app_id: str, manifest) -> None:
        """A node holding the complete image (origin, or a restored
        replica) joins the swarm as a pure seeder."""
        st, i = self._attach(px, app_id, manifest)
        st.full[i] = True
        st.fetching[i] = False
        st.grant_agenda.add(i)

    def register_leech(self, px, app_id: str, manifest) -> None:
        """A node starts fetching the image; pieces it already holds
        (cache rescan) are announced separately via `note_have`."""
        st, i = self._attach(px, app_id, manifest)
        st.fetching[i] = True
        st.full[i] = False
        st.dirty.add(i)
        # a new candidate makes every free-slot holder grantable again
        st.grant_scan = True

    def _reset_row(self, st: SwarmState, i: int) -> None:
        st.touch(i)
        if st.have_n[i]:
            st.counts -= st.have[i].astype(np.int32)
            st.have[i, :] = False
            st.have_n[i] = 0
            st.avail_epoch += 1
        st.full[i] = False
        st.fetching[i] = False
        st.starved[i] = False
        st.opt_peer[i] = -1
        st.newly_full = [j for j in st.newly_full if j != i]
        self._release_slots(st, i)
        # grants row i made: adjacency-only unlink (the old code wiped
        # the matrix row without touching the leechers' engine dicts —
        # PEER_GONE handles those on the wire)
        for l in st.uc_rows[i, : st.uc_n[i]].tolist():
            st._unlink(i, l)
        # rate history: this row's own edges plus every edge TO it (the
        # old col+row matrix wipe); O(n) dict pops, resets are rare
        st.edges[i].clear()
        for d in st.edges[: st.n]:
            d.pop(i, None)
        st.ledger_drop_row(i)
        st.grant_agenda.discard(i)

    def has_row(self, app_id: str, name: str) -> bool:
        return any(aid == app_id and name in st.row
                   for (aid, _), st in self.states.items())

    def retire(self, px, app_id: str, manifest) -> None:
        """`px` upgraded away from `manifest`'s revision: detach its row
        from the superseded (app_id, version) state so stale masks can
        never leak into the new swarm; the state itself is pruned once
        its last live row retires."""
        st = self.states.get(self._key(app_id, manifest))
        if st is None:
            return
        i = st.row.get(px.node_id)
        if i is None:
            return
        if st.alive[i]:
            st.alive[i] = False
            st.n_alive -= 1
            self._reset_row(st, i)
            st.avail_epoch += 1
        st.clients[i] = None
        if st.n_alive <= 0:
            self.states.pop(self._key(app_id, manifest), None)

    # ====================== state change mirrors ======================== #
    def note_have(self, px, app_id: str, piece_id: int) -> None:
        """A piece verified locally at `px` — the array-native stand-in
        for the swarm-wide HAVE announce fan-out."""
        st = self._lookup(px, app_id)
        if st is None:
            return
        i = st.row.get(px.node_id)
        if i is None:
            return
        if not st.have[i, piece_id]:
            if st.have_n[i] == 0 and not st.full[i]:
                # first piece: the row just became a grant-capable holder
                st.grant_agenda.add(i)
            st.have[i, piece_id] = True
            st.touch(i)
            st.have_n[i] += 1
            st.counts[piece_id] += 1
            st.avail_epoch += 1
            self.batch_ops += 1
            # the scalar engine would send one announce per swarm peer
            # plus the tracker copy (and the tracker would relay): count
            # the suppressed deliveries so events/s stays comparable
            self.coalesced += 2 * max(st.n_alive - 1, 0)
        st.dirty.add(i)

    def set_full(self, px, app_id: str) -> None:
        """`px` verified the whole image: seeder from now on."""
        st = self._lookup(px, app_id)
        if st is None:
            return
        i = st.row.get(px.node_id)
        if i is None:
            return
        st.full[i] = True
        st.touch(i)
        st.fetching[i] = False
        st.starved[i] = False
        st.dirty.discard(i)
        st.newly_full.append(i)

    def mark_dirty(self, px, app_id: str) -> None:
        """`px`'s pending set (or choke view) changed: re-pump the row on
        the next tick."""
        st = self._lookup(px, app_id)
        if st is None:
            return
        i = st.row.get(px.node_id)
        if i is not None and st.fetching[i]:
            st.dirty.add(i)

    def node_gone(self, name: str) -> None:
        """A node crashed (PEER_GONE): drop its holdings, slots, ledger
        and rate history from every swarm.  Idempotent; a restart
        re-registers."""
        for st in self.states.values():
            i = st.row.get(name)
            if i is None or not st.alive[i]:
                continue
            st.alive[i] = False
            st.n_alive -= 1
            self._reset_row(st, i)
            st.avail_epoch += 1

    def credit(self, px, app_id: str, peer: str, nbytes: int,
               received: bool) -> None:
        """Mirror of `_credit_from` / `_credit_to`: transfer bytes into
        the rolling per-link windows the batched rechoke ranks on.
        Sparse: one float32 scalar accumulate per edge (bit-identical
        to the former float32 matrix `+=`)."""
        st = self._lookup(px, app_id)
        if st is None:
            return
        i = st.row.get(px.node_id)
        j = st.row.get(peer)
        if i is None or j is None:
            return
        e = st.edges[i].get(j)
        if e is None:
            z = np.float32(0.0)
            e = st.edges[i][j] = [z, z, z, z]
        k = 0 if received else 2
        e[k] = e[k] + np.float32(nbytes)

    # ---------------------- ledger notification hooks ------------------- #
    # Fired by PieceExchange._req_add/_req_del/_req_clear/_req_drop — the
    # single funnel every pending-dict mutation goes through — so the
    # array ledger tracks the dict truth entry for entry.
    def ledger_add(self, px, app_id: str, piece_id: int, peer: str,
                   t: float) -> None:
        st = self._lookup(px, app_id)
        if st is None:
            return
        i = st.row.get(px.node_id)
        if i is None or st.clients[i] is not px:
            return
        j = st.row.get(peer)
        st.ledger_add_row(i, int(piece_id), -2 if j is None else int(j),
                          float(t))
        self.ledger_ops += 1

    def ledger_del(self, px, app_id: str, piece_id: int,
                   peer: str) -> None:
        st = self._lookup(px, app_id)
        if st is None:
            return
        i = st.row.get(px.node_id)
        if i is None or st.clients[i] is not px:
            return
        j = st.row.get(peer)
        st.ledger_del_row(i, int(piece_id), -2 if j is None else int(j))
        self.ledger_ops += 1

    def ledger_clear(self, px, app_id: str, piece_id: int) -> None:
        st = self._lookup(px, app_id)
        if st is None:
            return
        i = st.row.get(px.node_id)
        if i is None or st.clients[i] is not px:
            return
        st.ledger_clear_row(i, int(piece_id))
        self.ledger_ops += 1

    def ledger_drop(self, px, app_id: str) -> None:
        st = self._lookup(px, app_id)
        if st is None:
            return
        i = st.row.get(px.node_id)
        if i is None or st.clients[i] is not px:
            return
        st.ledger_drop_row(i)
        self.ledger_ops += 1

    # ========================= choke mechanics ========================== #
    def _release_slots(self, st: SwarmState, i: int) -> None:
        """Free every upload slot granted TO row i (batched
        `_promote_full_seeder`): seeders stop being unchoke candidates."""
        name = st.names[i]
        k = int(st.ub_n[i])
        if not k:
            return
        holders = st.ub_rows[i, :k].tolist()
        for h in holders:
            st._unlink(h, i)
            st.grant_agenda.add(h)
            px_h = st.clients[h]
            if px_h is not None:
                px_h.unchoked[st.app_id].discard(name)
                px_h.interested[st.app_id].discard(name)
                px_h.queued_reqs[st.app_id].pop(name, None)
        self.batch_ops += len(holders)

    def _apply_grant(self, st: SwarmState, h: int, i: int) -> None:
        """Holder row h unchokes leecher row i: zero-latency stand-in for
        the INTERESTED -> UNCHOKE exchange.  Queued endgame requests are
        served immediately, exactly as the scalar `_unchoke` does."""
        st._link(h, i)
        app_id = st.app_id
        name_i, name_h = st.names[i], st.names[h]
        px_h, px_i = st.clients[h], st.clients[i]
        if px_h is not None:
            px_h.unchoked[app_id].add(name_i)
            queued = px_h.queued_reqs[app_id].pop(name_i, None)
            if queued:
                for piece_id in sorted(queued):
                    px_h._serve(app_id, name_i, piece_id)
        if px_i is not None:
            px_i.unchoked_by[app_id].add(name_h)
        st.dirty.add(i)
        self.batch_ops += 1
        self.coalesced += 2           # INTERESTED + UNCHOKE never sent

    def _apply_choke(self, st: SwarmState, h: int, i: int) -> None:
        """Holder row h chokes leecher row i; the leecher immediately
        re-routes solely-pending requests (the scalar `on_choke` body,
        via the holder-indexed `_route_choked`)."""
        st._unlink(h, i)
        st.grant_agenda.add(h)
        app_id = st.app_id
        name_i, name_h = st.names[i], st.names[h]
        px_h, px_i = st.clients[h], st.clients[i]
        if px_h is not None:
            px_h.unchoked[app_id].discard(name_i)
        if px_i is not None:
            px_i.unchoked_by[app_id].discard(name_h)
            px_i._route_choked(app_id, name_h)
            st.dirty.add(i)
        self.batch_ops += 1
        self.coalesced += 1           # CHOKE never sent

    def grant(self, px, app_id: str, peer: str) -> bool:
        """Holder-initiated unchoke (the scalar `_maybe_unchoke_now` fast
        path reacting to a live PIECE_REQ): applied through the arrays.
        Returns False when either side has no row yet — the caller then
        falls back to the wire message."""
        st = self._lookup(px, app_id)
        if st is None:
            return False
        h = st.row.get(px.node_id)
        i = st.row.get(peer)
        if h is None or i is None:
            return False
        self._apply_grant(st, h, i)
        return True

    def choke(self, px, app_id: str, peer: str) -> bool:
        """Holder-initiated choke, applied through the arrays (the peer
        re-routes immediately instead of waiting for a CHOKE message)."""
        st = self._lookup(px, app_id)
        if st is None:
            return False
        h = st.row.get(px.node_id)
        i = st.row.get(peer)
        if h is None or i is None:
            return False
        self._apply_choke(st, h, i)
        return True

    def _fill_list(self, st: SwarmState, glist: np.ndarray,
                   isl: Optional[int],
                   cache: Dict[Optional[int], np.ndarray]) -> np.ndarray:
        """Fetching rows in grant-preference order for a holder on
        island `isl`: (cost, name-rank) lexicographic under topology,
        pure name order otherwise.  `glist` is already rank-ordered, so
        a stable sort by cost alone preserves the within-cost order."""
        wl = cache.get(isl)
        if wl is None:
            if isl is None or self.cost_matrix is None:
                wl = glist
            else:
                costs = self.cost_matrix[isl, st.island[glist]]
                wl = glist[np.argsort(costs, kind="stable")]
            cache[isl] = wl
        return wl

    def _grants(self, st: SwarmState) -> None:
        """Fill free upload slots with the lowest-named fetching leechers
        (batched `_maybe_unchoke_now`).  Event-driven: only holders on
        the agenda (slot freed, candidate choked away, new holder) are
        visited, plus a full sweep whenever a new fetching row appeared;
        identical grants to the old full want-matrix scan, without the
        O(holders x leechers) rebuild per tick."""
        n = st.n
        cand = st.fetching[:n] & st.alive[:n]
        if not cand.any():
            return
        slots = max(int(self._cfg.upload_slots), 1)
        holders = st.holder_mask()
        free = st.uc_n[:n] < slots
        if st.grant_scan:
            hs = np.nonzero(holders & free)[0]
            st.grant_scan = False
            st.grant_agenda.clear()
        else:
            if not st.grant_agenda:
                return
            ag = np.fromiter(st.grant_agenda, dtype=np.int64,
                             count=len(st.grant_agenda))
            st.grant_agenda.clear()
            ag = ag[ag < n]
            hs = ag[holders[ag] & free[ag]]
            hs.sort()
        if hs.size == 0:
            return
        ranks = st.ranks
        glist = np.nonzero(cand)[0]
        glist = glist[np.argsort(ranks[glist], kind="stable")]
        cache: Dict[Optional[int], np.ndarray] = {}
        for h in hs:
            h = int(h)
            nfree = slots - int(st.uc_n[h])
            if nfree <= 0:
                continue
            isl = int(st.island[h]) if self.cost_matrix is not None else None
            wl = self._fill_list(st, glist, isl, cache)
            members = st.uc_set(h)
            granted = 0
            # the walk grants the first nfree non-member rows; at most
            # len(members) + 1 entries are skipped (self + existing
            # grants), so only a constant-size prefix is ever visited —
            # never materialize the full O(N) fetching list per holder
            for i in wl[: nfree + len(members) + 1].tolist():
                if granted >= nfree:
                    break
                if i == h or i in members:
                    continue
                self._apply_grant(st, h, i)
                granted += 1

    def _rechoke(self, st: SwarmState, now: float) -> None:
        """Batched periodic rechoke: one `choke_order` kernel call ranks
        every holder's candidate SHORTLIST — its nonzero-rate edge
        partners plus the first slots-1 rank-ordered zero-rate
        candidates, which provably contains the true top slots-1 (all
        other candidates tie at rate zero and lose the name tie-break to
        the fill) — by reciprocal rate; the optimistic slot rotates
        through the name-ordered rest via the scalar index arithmetic
        (`rest[self._opt_idx % len(rest)]`)."""
        st.rechoke_round += 1
        every = max(int(getattr(self._cfg, "optimistic_every", 3)), 1)
        rotate = st.rechoke_round % every == 0
        n = st.n
        slots = max(int(self._cfg.upload_slots), 1)
        cand = st.fetching[:n] & st.alive[:n]
        holders = np.nonzero(st.holder_mask())[0]
        ranks = st.ranks
        # fetching rows in name order: the scalar `rest = sorted(cands)`
        glist = np.nonzero(cand)[0]
        glist = glist[np.argsort(ranks[glist], kind="stable")]
        pos = np.full(n, -1, dtype=np.int64)
        pos[glist] = np.arange(glist.size)
        n_cand = int(cand.sum())
        ranked = [int(h) for h in holders
                  if n_cand - int(cand[h]) > slots]
        order = None
        shortlists: List[List[int]] = []
        if ranked:
            cache: Dict[Optional[int], np.ndarray] = {}
            for h in ranked:
                nz = [j for j in st.edges[h]
                      if j < n and cand[j] and j != h]
                members = set(nz)
                isl = int(st.island[h]) if self.cost_matrix is not None \
                    else None
                wl = self._fill_list(st, glist, isl, cache)
                fill: List[int] = []
                needed = slots - 1
                for x in wl.tolist():
                    if len(fill) >= needed:
                        break
                    if x == h or x in members:
                        continue
                    fill.append(x)
                shortlists.append(nz + fill)
            C = max(max((len(s) for s in shortlists), default=0), 1)
            H = len(ranked)
            recv_p = np.zeros((H, C), dtype=np.float32)
            sent_p = np.zeros((H, C), dtype=np.float32)
            cm = np.zeros((H, C), dtype=bool)
            rk = np.zeros((H, C), dtype=np.int64)
            for k, (h, sl) in enumerate(zip(ranked, shortlists)):
                if not sl:
                    continue
                cm[k, : len(sl)] = True
                d = st.edges[h]
                for m, j in enumerate(sl):
                    e = d.get(j)
                    if e is not None:
                        recv_p[k, m] = e[0] + e[1]
                        sent_p[k, m] = e[2] + e[3]
                slr = np.asarray(sl, dtype=np.int64)
                key = ranks[slr]
                if self.cost_matrix is not None:
                    # P4P tie-break: reciprocal rates stay primary, but
                    # rate ties resolve cheapest-island-first.  Small
                    # shift: the same int32-safe layout as the matcher.
                    key = self.cost_matrix[st.island[h],
                                           st.island[slr]] \
                        * _CHOKE_COST_SHIFT + key
                rk[k, : len(sl)] = key
            _, order = self._kernel(choke_order, self._up(recv_p),
                                    self._up(sent_p), self._up(cm),
                                    self._up(rk))
        krow = {h: k for k, h in enumerate(ranked)}
        for h in holders:
            h = int(h)
            k = krow.get(h)
            if k is None:
                # few candidates: everyone fetching gets a slot
                new = {int(i) for i in glist if i != h}
                st.opt_peer[h] = -1
            else:
                sl = shortlists[k]
                top = [sl[int(c)] for c in order[k, : slots - 1]]
                new = set(top)
                # optimistic slot from the name-ordered rest
                rest_len = n_cand - int(cand[h]) - (slots - 1)
                opt = int(st.opt_peer[h])
                in_rest = (opt >= 0 and opt != h and opt < n
                           and cand[opt] and opt not in new)
                if rotate or not in_rest:
                    st.opt_idx[h] += 1
                    t = int(st.opt_idx[h]) % rest_len
                    # rest == glist minus {h} and the top rows: selecting
                    # rest[t] = the t-th surviving element of glist
                    excl = sorted(int(pos[x]) for x in top + [h]
                                  if 0 <= x < n and pos[x] >= 0)
                    for e in excl:
                        if e <= t:
                            t += 1
                    opt = int(glist[t])
                st.opt_peer[h] = opt
                new.add(opt)
            old = st.uc_set(h)
            if old != new:
                for i in sorted(old - new, key=lambda x: ranks[x]):
                    self._apply_choke(st, h, int(i))
                for i in sorted(new - old, key=lambda x: ranks[x]):
                    self._apply_grant(st, h, int(i))
        # tumble the rate windows so ranking tracks *current* throughput
        window = float(getattr(self._cfg, "rate_window_s", 20.0))
        if now - st.win_start >= window:
            for d in st.edges[:n]:
                dead = []
                for j, e in d.items():
                    e[1] = e[0]
                    e[3] = e[2]
                    z = np.float32(0.0)
                    e[0] = z
                    e[2] = z
                    if e[1] == 0.0 and e[3] == 0.0:
                        dead.append(j)
                for j in dead:
                    del d[j]
            st.win_start = now

    # ========================== piece selection ========================= #
    def _piece_cost(self, st: SwarmState,
                    rows: torch.Tensor) -> torch.Tensor:
        """(len(rows), P) int64 cheapest-holder cost plane rows for the
        given leecher rows, on the device: the alive have plane
        ``(have | full) & alive`` reduced to island-level availability,
        the per-source-island cost plane, and each leecher's own island's
        row of it, read from the device planes in one `island_cost_rows`
        launch."""
        return island_cost_rows(st.have_d, st.full_d, st.alive_d,
                                st.island_d, st.n, rows, self.cost_matrix_d)

    def _orders(self, st: SwarmState, rows: np.ndarray,
                missing: np.ndarray) -> torch.Tensor:
        """(len(rows), P) int32 piece orders on the device: the missing
        mask goes up once, the keys (rarity, or cost then rarity under
        P4P) and their stable sort stay on the device."""
        st.sync_planes()
        missing_d = self._up(missing)
        counts_d = self._up(st.counts)
        offsets_d = self._up(st.offsets[rows])
        if self.cost_matrix is None:
            return rarest_orders(missing_d, counts_d, offsets_d, st.P)
        pc = self._piece_cost(st, self._up(rows.astype(np.int64)))
        # span from the host copy of the counts: no device sync
        max_count = int(st.counts.max()) if st.counts.size else 0
        return cost_orders(missing_d, counts_d, offsets_d, pc, st.P,
                           max_count=max_count)

    def _holder_costs(self, st: SwarmState, i: int) -> Optional[np.ndarray]:
        """(n,) ALTO cost from leecher row i's island to every row's
        island, or None when no topology is set."""
        if self.cost_matrix is None:
            return None
        return self.cost_matrix[st.island[i], st.island[: st.n]]

    def _usable_rows(self, st: SwarmState, i: int) -> np.ndarray:
        """Holder rows leecher i may address a request to right now:
        unchoked-by (unless choking is globally off), holding something,
        alive, not this node, not banned, and with no request of ours
        already in flight (one in-flight request per holder).  Scalar
        slow path / test bridge; the fused pass reads the same facts
        from the adjacency + busy ledger in bulk."""
        n = st.n
        px = st.clients[i]
        if getattr(self._cfg, "choke", True):
            ux = np.zeros(n, dtype=bool)
            k = int(st.ub_n[i])
            if k:
                hb = st.ub_rows[i, :k]
                ux[hb[hb < n]] = True
        else:
            ux = np.ones(n, dtype=bool)
        ux &= st.holder_mask()
        ux[i] = False
        app_id = st.app_id
        busy = {peer for asked in px.pending.get(app_id, {}).values()
                for peer in asked}
        bad = px.bad_peers.get(app_id)
        if bad:
            busy = busy | bad
        for name in busy:
            j = st.row.get(name)
            if j is not None:
                ux[j] = False
        return ux

    def _match_row(self, st: SwarmState, i: int, order: np.ndarray,
                   now: float) -> Tuple[List[Tuple[int, int]], bool]:
        """Walk one leecher's rarest-first order and pick a holder per
        piece with the scalar tie-breaks (shunned holders last, then
        lowest name).  Pure: returns ([(piece, holder_row)], starved)
        without touching any state.  Slow path for rows with shun/ban
        state (and the decide_requests test bridge); the fused
        `match_requests_ragged` kernel reproduces this walk for all clean
        rows at once."""
        px = st.clients[i]
        app_id = st.app_id
        pending = px.pending.get(app_id, {})
        budget = int(px.cfg.piece_pipeline) - len(pending)
        left = st.P - int(st.have_n[i]) - len(pending)
        out: List[Tuple[int, int]] = []
        if budget <= 0 or left <= 0:
            return out, False
        ux = self._usable_rows(st, i)
        idx = np.nonzero(ux)[0]
        if idx.size == 0:
            return out, True
        stalled = px.stalled_holders.get(app_id, {})
        ranks = st.ranks
        costs = self._holder_costs(st, i)
        taken = np.zeros(idx.size, dtype=bool)
        n_missing = st.P - int(st.have_n[i]) - len(pending)
        for k in range(min(n_missing, order.shape[0])):
            if budget <= 0:
                break
            if taken.all():
                break
            p = int(order[k])
            ok = ~taken & (st.have[idx, p] | st.full[idx])
            cand = idx[ok]
            if cand.size == 0:
                continue
            key = ranks[cand].astype(np.int64)
            if costs is not None:
                # P4P holder tie-break: cheapest island first, then name;
                # the shun bit still dominates the cost (bias decays when
                # same-island holders starve)
                key = key + costs[cand] * _COST_SHIFT
            shun = stalled.get(p)
            if shun:
                key = key + np.array(
                    [st.names[int(j)] in shun for j in cand],
                    dtype=np.int64) * _SHUN_INF
            j = int(cand[int(np.argmin(key))])
            out.append((p, j))
            taken[np.searchsorted(idx, j)] = True
            budget -= 1
        starved = budget > 0 and len(out) < n_missing
        return out, starved

    def _issue(self, st: SwarmState, i: int, piece_id: int, j: int,
               now: float, endgame: bool = False) -> None:
        """Commit one request decision: engine dicts + ledger (via the
        `_req_add` funnel) + the real PIECE_REQ wire message (link
        model, faults and chaos still apply to it)."""
        px = st.clients[i]
        name_j = st.names[j]
        px._req_add(st.app_id, piece_id, name_j, now)
        px._send_req(st.app_id, piece_id, name_j, endgame=endgame)
        self.batch_ops += 1

    def _pump(self, st: SwarmState, now: float) -> None:
        """Fused pump: budgets and missing masks come straight off the
        ledger counters (no dict walks), piece orders from ONE
        `rarest_orders` kernel call, and holder matching for every clean
        row from ONE `match_requests_ragged` call — each row's own
        candidates (CSR) from the unchoke adjacency, so total work is
        O(edges), busy holders excluded via the compact per-row busy
        list.  Rows with shun/ban state (or choke globally off) fall back
        to the scalar `_match_row`."""
        n = st.n
        avail_moved = st.avail_epoch != st.pump_epoch
        sel = np.zeros(n, dtype=bool)
        for i in st.dirty:
            if i < n:
                sel[i] = True
        if avail_moved:
            sel |= st.starved[:n]
        sel &= st.fetching[:n] & st.alive[:n]
        st.dirty.clear()
        st.pump_epoch = st.avail_epoch
        rows = np.nonzero(sel)[0]
        if rows.size == 0:
            return
        app_id = st.app_id
        budgets = (st.pipeline[rows] - st.pend_n[rows]).astype(np.int64)
        n_missing = (st.P - st.have_n[rows] - st.pend_n[rows]) \
            .astype(np.int64)
        live = (budgets > 0) & (n_missing > 0)
        st.starved[rows[~live]] = False
        rows = rows[live]
        budgets = budgets[live]
        n_missing = n_missing[live]
        if rows.size == 0:
            return
        missing = ~st.have[rows, :] & ~(st.pend_cnt[rows, :] > 0)
        orders_d, orders = self._kernel(self._orders, st, rows, missing)
        # slow-path detection: shunned or banned holders need the
        # name-set exclusion logic only the dict walk implements
        slow = np.zeros(rows.size, dtype=bool)
        if not getattr(self._cfg, "choke", True):
            slow[:] = True
        else:
            for k, i in enumerate(rows):
                px = st.clients[int(i)]
                if px is None or px.stalled_holders.get(app_id) \
                        or px.bad_peers.get(app_id):
                    slow[k] = True
        decisions: List[Optional[List[Tuple[int, int]]]] = \
            [None] * rows.size
        starved_out = np.zeros(rows.size, dtype=bool)
        fast = np.nonzero(~slow)[0]
        if fast.size:
            self._match_fast(st, rows, fast, orders_d, orders, budgets,
                             n_missing, decisions, starved_out)
        for k in np.nonzero(slow)[0]:
            decisions[k], starved_out[k] = self._match_row(
                st, int(rows[k]), orders[k], now)
        # commit in ascending row order (the old per-row loop's wire
        # order); decisions are row-independent so batch-then-issue is
        # exact
        for k in range(rows.size):
            i = int(rows[k])
            for piece_id, j in decisions[k] or ():
                self._issue(st, i, piece_id, j, now)
            st.starved[i] = bool(starved_out[k])

    def _staging(self, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(host, device) int32 staging of at least ``n`` words.  The host
        buffer is pinned on the card, so one non-blocking copy uploads it.
        Reusing it is safe because every pump ends in the blocking
        device-to-host copy of its picks, after which the previous upload
        has finished."""
        if self._stage_h is None or self._stage_h.numel() < n:
            size = 1 << max(int(n) - 1, 1023).bit_length()
            if self.device.type == "cuda":
                self._stage_h = torch.empty(size, dtype=torch.int32,
                                            pin_memory=True)
                self._stage_d = torch.empty(size, dtype=torch.int32,
                                            device=self.device)
            else:
                self._stage_h = torch.empty(size, dtype=torch.int32)
                self._stage_d = self._stage_h
        return self._stage_h, self._stage_d

    def _match_call(self, st: SwarmState, orders_d: torch.Tensor,
                    parts: Tuple[np.ndarray, ...],
                    ok: np.ndarray) -> torch.Tensor:
        """Pack the matcher's host inputs (int32 ``parts``: cand_ptr,
        row_of, n_walk, budgets, cand, cand_key; then the ``ok`` bytes)
        into the staging buffer, upload it with one copy and launch
        `match_requests_ragged` on views of it."""
        sizes = [a.size for a in parts]
        n_words = sum(sizes) + (ok.size + 3) // 4
        host, dev = self._staging(n_words)
        h = host.numpy()
        views, at = [], 0
        for a, n in zip(parts, sizes):
            h[at:at + n] = a
            views.append(dev[at:at + n])
            at += n
        h.view(np.uint8)[4 * at:4 * at + ok.size] = ok
        ok_d = dev.view(torch.uint8)[4 * at:4 * at + ok.size]
        if dev is not host:
            dev[:n_words].copy_(host[:n_words], non_blocking=True)
        ptr_d, row_of_d, walk_d, budget_d, cand_d, key_d = views
        return match_requests_ragged(orders_d, row_of_d, ptr_d, cand_d, ok_d,
                                     key_d, walk_d, budget_d, st.have_d,
                                     st.full_d, cand_ptr_host=parts[0])

    def _match_fast(self, st: SwarmState, rows: np.ndarray,
                    fast: np.ndarray, orders_d: torch.Tensor,
                    orders: np.ndarray, budgets: np.ndarray,
                    n_missing: np.ndarray,
                    decisions: List[Optional[List[Tuple[int, int]]]],
                    starved_out: np.ndarray) -> None:
        """Fused holder matching for the clean rows: ONE
        `match_requests_ragged` call over every row that has candidates,
        each row's candidates laid out flat (CSR) in the order of
        ``fast``.  The kernel reads this pump's orders (`orders_d`, row
        ``row_of[r]``) and the have/full planes on the device; `orders` is
        their host copy."""
        deg = st.ub_n[rows[fast]]
        for k in fast[deg == 0].tolist():
            # no unchoked-by holders at all: no requests, starved
            # (scalar `_usable_rows` empty -> ([], True))
            decisions[k] = []
            starved_out[k] = True
        idx = fast[deg > 0]
        if idx.size == 0:
            return
        sub = rows[idx]
        cnts = st.ub_n[sub].astype(np.int64)
        ptr = np.zeros(idx.size + 1, dtype=np.int64)
        np.cumsum(cnts, out=ptr[1:])
        rowid = np.repeat(np.arange(idx.size), cnts)
        owner = sub[rowid]
        cand = st.ub_rows[owner, np.arange(ptr[-1]) - ptr[rowid]]
        ok = ((st.have_n[cand] > 0) | st.full[cand]) & st.alive[cand] \
            & (cand != owner)
        B = int(st.busy_n[sub].max())
        if B:
            bz = st.busy_rows[sub, :B]
            bval = np.arange(B)[None, :] < st.busy_n[sub][:, None]
            bz = np.where(bval, bz, -1)
            ok &= ~(cand[:, None] == bz[rowid]).any(axis=1)
        key = st.ranks[cand]
        if self.cost_matrix is not None:
            key = self.cost_matrix[st.island[owner], st.island[cand]] \
                * _CHOKE_COST_SHIFT + key
        _, picks = self._kernel(self._match_call, st, orders_d,
                                (ptr, idx, n_missing[idx], budgets[idx],
                                 cand, key), ok)
        for kk, k in enumerate(idx.tolist()):
            pk = picks[kk]
            got = np.nonzero(pk >= 0)[0]
            decisions[k] = [(int(orders[k, g]), int(pk[g]))
                            for g in got.tolist()]
            starved_out[k] = (got.size < n_missing[k]
                              and got.size < budgets[k])

    def _endgame(self, st: SwarmState, now: float) -> None:
        """Fused endgame: row selection is pure ledger arithmetic
        (`P - have_n == pend_n`), per-piece candidate shortlists come
        from ONE `holder_topk` kernel call (K = 2*cap+1 provably covers
        every row's need), and the already-asked exclusion is a
        vectorized compare against the ledger slots.  Scalar fallback
        per row under shun/ban state.  Duplicates go out in ascending
        piece-id order (the dict path used insertion order — same
        duplicate set, different wire order; documented approximation).
        """
        if not getattr(self._cfg, "endgame", True):
            return
        n = st.n
        app_id = st.app_id
        miss = st.P - st.have_n[:n]
        eg = st.fetching[:n] & st.alive[:n] & (st.have_n[:n] > 0) \
            & (st.pend_n[:n] > 0) & (miss == st.pend_n[:n])
        rows = np.nonzero(eg)[0]
        if rows.size == 0:
            return
        fastrows: List[int] = []
        out: Dict[int, List[Tuple[int, int]]] = {}
        for i in rows.tolist():
            px = st.clients[i]
            if px is None:
                continue
            if px.stalled_holders.get(app_id) or px.bad_peers.get(app_id):
                out[i] = self._endgame_row(st, i)
            else:
                fastrows.append(i)
        if fastrows:
            out.update(self._endgame_fast(st, np.asarray(fastrows,
                                                         dtype=np.int64)))
        for i in sorted(out):
            for piece_id, j in out[i]:
                self._issue(st, i, piece_id, j, now, endgame=True)

    def _endgame_row(self, st: SwarmState,
                     i: int) -> List[Tuple[int, int]]:
        """Scalar per-row endgame decisions (dict-reading slow path for
        rows with shun/ban state); pure."""
        px = st.clients[i]
        app_id = st.app_id
        pending = px.pending.get(app_id)
        if not pending:
            return []
        n = st.n
        cap = max(int(getattr(px.cfg, "endgame_dup", 3)), 1)
        stalled = px.stalled_holders.get(app_id, {})
        bad = px.bad_peers.get(app_id, ())
        costs = self._holder_costs(st, i)
        ranks = st.ranks
        out: List[Tuple[int, int]] = []
        for piece_id, asked in list(pending.items()):
            room = cap - len(asked)
            if room <= 0:
                continue
            shun = stalled.get(piece_id, ())
            hm = (st.have[:n, piece_id] | st.full[:n]) & st.alive[:n]
            hm[i] = False
            cand = np.nonzero(hm)[0]
            hkey = ranks[cand]
            if costs is not None:
                # P4P endgame: duplicate to same-island holders first
                hkey = hkey + costs[cand] * _COST_SHIFT
            for j in cand[np.argsort(hkey, kind="stable")]:
                name = st.names[int(j)]
                if name in asked or name in shun or name in bad:
                    continue
                out.append((piece_id, int(j)))
                room -= 1
                if room <= 0:
                    break
        return out

    def _endgame_fast(self, st: SwarmState, rows: np.ndarray) \
            -> Dict[int, List[Tuple[int, int]]]:
        """Vectorized endgame duplicate selection for clean rows."""
        n = st.n
        D = st.pend_holder.shape[2]
        cnt = st.pend_cnt[rows].astype(np.int32)               # (R, P)
        caps = st.eg_cap[rows].astype(np.int32)[:, None]
        room = np.where(cnt > 0, caps - cnt, 0)
        np.clip(room, 0, None, out=room)
        out: Dict[int, List[Tuple[int, int]]] = {}
        if not (room > 0).any():
            return out
        K = int(2 * st.eg_cap[rows].max() + 1)
        hv = ((st.have_d[:n] | st.full_d[:n, None])
              & st.alive_d[:n, None]).to(torch.bool)
        inf = torch.full((), int(KEY_INF32), dtype=torch.int64,
                         device=self.device)
        ranks = st.ranks[:n].astype(np.int64)
        islands = [None] if self.cost_matrix is None else \
            np.unique(st.island[rows]).tolist()
        for isl in islands:
            if isl is None:
                rsel = np.arange(rows.size)
                base = ranks
            else:
                rsel = np.nonzero(st.island[rows] == isl)[0]
                base = self.cost_matrix[isl, st.island[:n]] \
                    * _CHOKE_COST_SHIFT + ranks
            key = torch.where(hv, self._up(base)[:, None], inf) \
                .to(torch.int32)
            _, top = self._kernel(holder_topk, key, K)         # (K, P)
            rr = rows[rsel]
            cand = top.T[None, :, :]                           # (1, P, K)
            asked = st.pend_holder[rr][:, :, :D]               # (R', P, D)
            excl = (cand[:, :, :, None] == asked[:, :, None, :]) \
                .any(axis=3)
            valid = (cand >= 0) & ~excl \
                & (cand != rr[:, None, None]) \
                & (room[rsel][:, :, None] > 0)
            csum = np.cumsum(valid, axis=2)
            chosen = valid & (csum <= room[rsel][:, :, None])
            ri, pi, ki = np.nonzero(chosen)
            for a, p, c in zip(ri.tolist(), pi.tolist(), ki.tolist()):
                i = int(rr[a])
                out.setdefault(i, []).append((int(p), int(top[c, p])))
        return out

    # ============================== tick ================================ #
    def tick(self, now: float) -> None:
        """One batched decision pass over every registered swarm."""
        t0 = time.perf_counter()
        self.ticks += 1
        for st in self.states.values():
            if st.n == 0:
                continue
            st.sync_planes()
            for i in st.newly_full:
                self._release_slots(st, i)
            st.newly_full.clear()
            if self._cfg is not None and getattr(self._cfg, "choke", True):
                self._grants(st)
                interval = float(
                    getattr(self._cfg, "rechoke_interval_s", 10.0))
                if now - st.last_rechoke >= interval:
                    st.last_rechoke = now
                    self._rechoke(st, now)
            self._pump(st, now)
            self._endgame(st, now)
        self.prof_tick_s += time.perf_counter() - t0

    # ====================== queries / test bridges ====================== #
    def _find(self, app_id: str, node_id: str) -> Optional[SwarmState]:
        """Newest-revision state of `app_id` holding a row for `node_id`
        (test-bridge lookup where no engine handle is available)."""
        best = None
        for (aid, ver), st in self.states.items():
            if aid != app_id or node_id not in st.row:
                continue
            if best is None or ver > best[0]:
                best = (ver, st)
        return None if best is None else best[1]

    def stats(self) -> Dict[str, float]:
        return {"ticks": self.ticks, "batch_ops": self.batch_ops,
                "coalesced_events": self.coalesced,
                "ledger_ops": self.ledger_ops,
                "tick_wall_s": self.prof_tick_s,
                "kernel_wall_s": self.prof_kernel_s}

    def decide_requests(self, app_id: str, node_id: str,
                        now: float) -> List[Tuple[int, str]]:
        """Pure query: the (piece, holder) requests the batched engine
        would issue for one node right now — the differential tests'
        bridge to the scalar `pump`."""
        st = self._find(app_id, node_id)
        i = st.row[node_id]
        px = st.clients[i]
        missing = ~st.have[i, :]       # invert copies; safe to edit
        for p in px.pending.get(app_id, {}):
            missing[p] = False
        order = self._orders(st, np.array([i], dtype=np.int64),
                             missing[None, :]).cpu().numpy()[0]
        decisions, _ = self._match_row(st, i, order, now)
        return [(p, st.names[j]) for p, j in decisions]

    def decide_endgame(self, app_id: str, node_id: str,
                       now: float) -> List[Tuple[int, str]]:
        """Pure query: the endgame duplicates the batched engine would
        issue for one node (scalar `_endgame` bridge)."""
        st = self._find(app_id, node_id)
        i = st.row[node_id]
        px = st.clients[i]
        pending = px.pending.get(app_id, {})
        if not pending or not int(st.have_n[i]):
            return []
        if st.P - int(st.have_n[i]) != len(pending):
            return []
        n = st.n
        cap = max(int(getattr(px.cfg, "endgame_dup", 3)), 1)
        stalled = px.stalled_holders.get(app_id, {})
        bad = px.bad_peers.get(app_id, ())
        ranks = st.ranks
        costs = self._holder_costs(st, i)
        out: List[Tuple[int, str]] = []
        for piece_id, asked in pending.items():
            room = cap - len(asked)
            if room <= 0:
                continue
            shun = stalled.get(piece_id, ())
            hm = (st.have[:n, piece_id] | st.full[:n]) & st.alive[:n]
            hm[i] = False
            cand = np.nonzero(hm)[0]
            hkey = ranks[cand]
            if costs is not None:
                hkey = hkey + costs[cand] * _COST_SHIFT
            for j in cand[np.argsort(hkey, kind="stable")]:
                name = st.names[int(j)]
                if name in asked or name in shun or name in bad:
                    continue
                out.append((piece_id, name))
                room -= 1
                if room <= 0:
                    break
        return out

    @classmethod
    def mirror_scalar(cls, px, app_id: str,
                      device="cuda") -> "SwarmHub":
        """Build a hub whose arrays mirror a *scalar-mode* engine's view
        of one swarm (peer masks, full seeders, choke view) — used by
        the differential tests to compare decisions on identical
        information sets."""
        hub = cls(device=device)
        manifest = px.manifests[app_id]
        hub.register_leech(px, app_id, manifest)
        st = hub.states[hub._key(app_id, manifest)]
        me = st.row[px.node_id]
        inv = px.inventories.get(app_id)
        if inv is not None:
            for p in inv.have:
                hub.note_have(px, app_id, p)
        full_mask = manifest.full_mask
        for peer, mask in px.peer_masks.get(app_id, {}).items():
            if peer == px.node_id:
                continue
            j = st.ensure_row(peer)
            mask &= full_mask
            while mask:
                low = mask & -mask
                p = low.bit_length() - 1
                mask ^= low
                st.have[j, p] = True
                st.have_n[j] += 1
                st.counts[p] += 1
            st.touch(j)
        for peer in px.full_seeders.get(app_id, ()):
            j = st.ensure_row(peer)
            st.full[j] = True
            st.touch(j)
        for holder in px.unchoked_by.get(app_id, ()):
            st._link(st.ensure_row(holder), me)
        return hub
