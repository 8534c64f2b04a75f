"""Applications, parts, pieces and leases.

An Application is split into parts ("cycles" in the paper's tests); the host
leases parts to leechers, tracks them via TAIL, and re-DISTs on timeout.
Leases are also the framework's unit of data-pipeline fault tolerance.

The paper's §V extension adds a second axis of division: the application
*image* itself is broken into fixed-size, content-hashed pieces described by
a `PieceManifest` (metainfo, like a .torrent file).  Volunteers track their
holdings in a `PieceInventory`, verify every piece against the manifest, and
any volunteer with a complete image may re-seed it.  Executables are resolved
through a registry keyed by the manifest hash — possession of the verified
image is what grants the right to look up and run the code, replacing any
side-channel between nodes.
"""
from __future__ import annotations

import functools
import hashlib
import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set, Tuple


def _hash(*fields: object) -> str:
    h = hashlib.sha1()
    for f in fields:
        h.update(str(f).encode())
        h.update(b"\0")
    return h.hexdigest()


# ---- piece bitmasks ------------------------------------------------------- #
# HAVE/PIECE_DATA announcements carry holdings as a compact int bitmask
# (bit p set <=> piece p held) so announce traffic scales O(pieces/8) bytes
# per message instead of O(pieces) list entries.
def mask_of(pieces) -> int:
    mask = 0
    for p in pieces:
        mask |= 1 << p
    return mask


def pieces_of(mask: int) -> Set[int]:
    out: Set[int] = set()
    p = 0
    while mask:
        if mask & 1:
            out.add(p)
        mask >>= 1
        p += 1
    return out


def mask_nbytes(mask: int) -> int:
    """On-wire size of a bitmask (for honest Msg.size_bytes accounting)."""
    return (mask.bit_length() + 7) // 8


@dataclass(frozen=True)
class PieceManifest:
    """Metainfo for piece-wise image distribution (paper §V).

    Mirrors a .torrent info dict: piece size, piece count and per-piece
    content hashes.  `manifest_hash` (the info-hash) identifies the exact
    application image and keys the executable registry.
    """
    app_id: str
    piece_bytes: int
    total_bytes: int
    piece_hashes: Tuple[str, ...]
    # True when piece_hashes are content hashes of real payload bytes
    # (from_bytes): verification then REQUIRES the bytes — the hashes are
    # public metainfo, so a bare proof proves nothing
    content_hashed: bool = False
    # revision chain: successive revisions of the same app_id carry a
    # monotonically increasing version and the manifest_hash of the
    # revision they supersede, so a swarm can diff v(k+1) against v(k)
    # and move only the changed pieces (delta distribution)
    version: int = 1
    prev_manifest_hash: Optional[str] = None

    @property
    def n_pieces(self) -> int:
        return len(self.piece_hashes)

    @functools.cached_property
    def manifest_hash(self) -> str:
        return _hash(self.app_id, self.piece_bytes, self.total_bytes,
                     self.version, self.prev_manifest_hash,
                     *self.piece_hashes)

    def supersedes(self, other: Optional["PieceManifest"]) -> bool:
        """True when this manifest is a strictly newer revision of the
        same application than `other` (None counts as "nothing held")."""
        if other is None:
            return True
        return (self.app_id == other.app_id
                and self.version > other.version)

    def delta(self, prev: Optional["PieceManifest"]) -> Set[int]:
        """Piece ids whose content differs from `prev` (positional hash
        compare).  Incomparable manifests (different piece size, different
        hashing mode, or no predecessor) conservatively report every
        piece as changed — nothing may be reused."""
        if (prev is None or prev.piece_bytes != self.piece_bytes
                or prev.content_hashed != self.content_hashed):
            return set(range(self.n_pieces))
        return {i for i, h in enumerate(self.piece_hashes)
                if i >= prev.n_pieces or prev.piece_hashes[i] != h}

    @functools.cached_property
    def full_mask(self) -> int:
        """Bitmask with every piece bit set (the complete-image HAVE)."""
        return (1 << self.n_pieces) - 1

    def piece_size(self, piece_id: int) -> int:
        if piece_id < self.n_pieces - 1:
            return self.piece_bytes
        rem = self.total_bytes - self.piece_bytes * (self.n_pieces - 1)
        return max(rem, 0)

    @classmethod
    def from_bytes(cls, app_id: str, image, piece_bytes: int, *,
                   version: int = 1,
                   prev: Optional["PieceManifest"] = None
                   ) -> "PieceManifest":
        # hash through zero-copy views: building a manifest for a large
        # image must not materialise a bytes copy per piece.  An empty
        # image is a 0-piece manifest (trivially complete, full_mask 0) —
        # a phantom zero-byte piece 0 could never be transferred or
        # verified, and a 0-delta upgrade would wedge on it.
        mv = memoryview(image)
        hashes = tuple(
            hashlib.sha1(mv[i:i + piece_bytes]).hexdigest()
            for i in range(0, len(mv), piece_bytes))
        return cls(app_id, piece_bytes, len(mv), hashes,
                   content_hashed=True, version=version,
                   prev_manifest_hash=prev.manifest_hash
                   if prev is not None else None)

    @classmethod
    def synthetic(cls, app_id: str, total_bytes: int, piece_bytes: int, *,
                  version: int = 1,
                  prev: Optional["PieceManifest"] = None,
                  changed: Optional[Set[int]] = None) -> "PieceManifest":
        """Manifest for a simulated image: hashes are derived, no bytes are
        materialised (benchmarks use multi-GB images).

        Piece hashes deliberately do NOT fold in the version, so a new
        revision of the same (app_id, total_bytes) shares hashes with its
        predecessor except for `changed` pieces — that is what makes the
        synthetic path a usable delta-distribution workload.
        """
        n = (-(-total_bytes // max(piece_bytes, 1))
             if total_bytes > 0 else 0)
        changed = changed or set()
        hashes = tuple(
            _hash(app_id, total_bytes, i, "rev", version) if i in changed
            else _hash(app_id, total_bytes, i)
            for i in range(n))
        return cls(app_id, piece_bytes, total_bytes, hashes,
                   version=version,
                   prev_manifest_hash=prev.manifest_hash
                   if prev is not None else None)


class PieceInventory:
    """Which pieces of one application image a volunteer holds (verified)."""

    def __init__(self, manifest: PieceManifest,
                 complete: bool = False):
        self.manifest = manifest
        self.have: Set[int] = (set(range(manifest.n_pieces)) if complete
                               else set())
        # holdings mirrored as an int bitmask so bitfield() is O(1): HAVE
        # announces fire once per verified piece per peer, and rebuilding
        # the mask from the set each time was O(pieces) on that hot path
        self._mask: int = (1 << manifest.n_pieces) - 1 if complete else 0

    def add(self, piece_id: int, proof: Optional[str] = None,
            data=None) -> bool:
        """Verify a piece against the manifest; reject corrupt pieces.

        Real transfers pass `data` (the payload slice) and the content hash
        is recomputed here — a peer cannot fake a proof for bogus bytes,
        and for a content-hashed manifest a bare proof is rejected outright
        (piece hashes are public metainfo; only the bytes prove holding).
        Synthetic (simulation) transfers pass only `proof`.
        """
        if not (0 <= piece_id < self.manifest.n_pieces):
            return False
        if data is not None:
            proof = hashlib.sha1(data).hexdigest()
        elif self.manifest.content_hashed:
            return False
        if proof != self.manifest.piece_hashes[piece_id]:
            return False
        self.have.add(piece_id)
        self._mask |= 1 << piece_id
        return True

    def has(self, piece_id: int) -> bool:
        return piece_id in self.have

    def missing(self) -> List[int]:
        return [i for i in range(self.manifest.n_pieces)
                if i not in self.have]

    @property
    def complete(self) -> bool:
        return len(self.have) == self.manifest.n_pieces

    def bitfield(self) -> int:
        """Holdings as a compact int bitmask (bit p set <=> piece p held)."""
        return self._mask

    def seed_from(self, prev: "PieceInventory",
                  read_piece: Optional[Callable[[int], Any]] = None
                  ) -> Set[int]:
        """Adopt still-valid pieces from a previous revision's inventory.

        Only pieces that are unchanged per ``manifest.delta(prev)`` AND
        verified in `prev` are candidates.  The reuse rule: for a
        content-hashed manifest the actual bytes are re-read through
        `read_piece(piece_id)` and re-hashed by add(data=...) — a reused
        piece is never trusted on faith, so a corrupt or stale cache can
        not leak into the new revision.  Synthetic manifests adopt by
        proof.  Returns the set of adopted piece ids.
        """
        changed = self.manifest.delta(prev.manifest)
        adopted: Set[int] = set()
        for pid in prev.have:
            if pid in changed or pid >= self.manifest.n_pieces:
                continue
            if self.manifest.content_hashed:
                data = read_piece(pid) if read_piece is not None else None
                if data is None:
                    continue
                ok = self.add(pid, data=data)
            else:
                ok = self.add(pid, proof=self.manifest.piece_hashes[pid])
            if ok:
                adopted.add(pid)
        return adopted


# --------------------------------------------------------------------------- #
# Executable registry: manifest hash -> runnable code + app blueprint.
#
# In a real deployment the verified image *is* the executable; in this
# in-process reproduction the registry stands in for "unpacking the image".
# An agent may only resolve a hash for an image it has fully verified, which
# removes the old back-door of reaching into the runtime's node table.
_EXECUTABLES: Dict[str, "ExecutableEntry"] = {}


@dataclass
class ExecutableEntry:
    run_fn: Optional[Callable[[Any], Any]]
    cost_fn: Optional[Callable[[Any, float], float]]
    blueprint: Optional[Callable[[], "Application"]] = None


def register_executable(manifest_hash: str,
                        run_fn: Optional[Callable[[Any], Any]],
                        cost_fn: Optional[Callable[[Any, float], float]],
                        blueprint: Optional[Callable[[], "Application"]] = None
                        ) -> None:
    _EXECUTABLES[manifest_hash] = ExecutableEntry(run_fn, cost_fn, blueprint)


def resolve_executable(manifest_hash: str) -> Optional[ExecutableEntry]:
    return _EXECUTABLES.get(manifest_hash)


@dataclass
class Part:
    part_id: int
    payload: Any                         # e.g. (lo, hi) range for primes
    data_bytes: int = 4096
    done: bool = False
    results: List[Tuple[str, Any, float]] = field(default_factory=list)
    # (volunteer_id, result, time_s) — for m_min-way majority voting
    # the majority_vote winner the part was validated with (set when
    # `done` flips); gossip must ship THIS, not a raw vote — results[0]
    # may be the minority/corrupt one
    winner: Any = None


@dataclass
class Application:
    app_id: str
    host_id: str
    run_fn: Optional[Callable[[Any], Any]] = None   # real execution
    cost_fn: Optional[Callable[[Any, float], float]] = None  # sim: (payload, speed)->s
    app_bytes: int = 4096
    parts: List[Part] = field(default_factory=list)
    m_min: int = 1
    m_max: int = 1
    # piece-wise distribution (paper §V): when `swarm` is set the image is
    # advertised via the manifest and moves as hashed pieces between
    # volunteers instead of riding on every APP_DATA
    swarm: bool = False
    piece_bytes: int = 1 << 16
    manifest: Optional[PieceManifest] = None
    # real application image: when set, pieces carry actual payload slices
    # of these bytes and the manifest hashes their content; when None the
    # image is synthetic (simulation) and pieces move as hash proofs
    image: Optional[bytes] = None
    # lazy open-part index (see _open); not part of the public state
    _open_idx: Optional["deque"] = field(default=None, repr=False)

    def ensure_manifest(self) -> PieceManifest:
        if self.manifest is None:
            if self.image is not None:
                self.manifest = PieceManifest.from_bytes(
                    self.app_id, self.image,
                    self.piece_bytes if self.swarm
                    else max(len(self.image), 1))
            else:
                self.manifest = PieceManifest.synthetic(
                    self.app_id, self.app_bytes,
                    self.piece_bytes if self.swarm
                    else max(self.app_bytes, 1))
        return self.manifest

    def blueprint(self) -> Callable[[], "Application"]:
        """Factory reconstructing this application from its image: fresh
        parts, same executables — what a replica seeder unpacks."""
        spec = [(p.part_id, p.payload, p.data_bytes) for p in self.parts]

        def make() -> "Application":
            return Application(
                self.app_id, self.host_id, run_fn=self.run_fn,
                cost_fn=self.cost_fn, app_bytes=self.app_bytes,
                parts=[Part(pid, payload, data_bytes=db)
                       for pid, payload, db in spec],
                m_min=self.m_min, m_max=self.m_max, swarm=self.swarm,
                piece_bytes=self.piece_bytes, manifest=self.manifest,
                image=self.image)
        return make

    def _open(self) -> "deque":
        """Positions of not-yet-done parts.  Built lazily, pruned as a
        side effect of every scan, so the per-DIST cost tracks the open
        part count instead of the full part list (`done` flips are
        monotonic; entries completed since the last scan self-heal out
        no matter who set the flag).  A deque so scans can rotate: the
        next grant resumes where the last one stopped instead of
        re-walking every currently-leased part at the front."""
        idx = self._open_idx
        if idx is None:
            idx = self._open_idx = deque(
                k for k, p in enumerate(self.parts) if not p.done)
        return idx

    def pending_parts(self, leased: Dict[int, list]) -> List[Part]:
        out = []
        idx = self._open()
        for _ in range(len(idx)):
            k = idx[0]
            part = self.parts[k]
            if part.done:
                idx.popleft()             # prune completed entries
                continue
            idx.rotate(-1)
            active = len(leased.get(part.part_id, []))
            needed = self.m_min - len(part.results) - active
            if needed > 0:
                out.append(part)
        return out

    def grant_candidate(self, leased: Dict[int, list],
                        in_partition: Callable[["Part"], bool],
                        acceptable: Callable[["Part"], bool]
                        ) -> Optional[Part]:
        """Next pending part in this seeder's partition that
        `acceptable` admits; when the partition holds no pending part at
        all, an acceptable pending part anywhere (the endgame fallback:
        a seeder whose partition drained helps finish the rest).

        Round-robin over the open-part index: every examined entry
        rotates to the back (done entries prune out instead), so the
        scan resumes after the previously granted part and the per-DIST
        cost is the distance to the next grantable part — NOT a re-walk
        of the O(active leases) saturated prefix that a front-first scan
        pays at N=10000 (the fallback still needs the one full cycle it
        always needed)."""
        idx = self._open()
        any_mine = False
        best_any = None
        for _ in range(len(idx)):
            k = idx[0]
            part = self.parts[k]
            if part.done:
                idx.popleft()             # prune completed entries
                continue
            idx.rotate(-1)
            active = len(leased.get(part.part_id, ()))
            if self.m_min - len(part.results) - active <= 0:
                continue
            if in_partition(part):
                any_mine = True
                if acceptable(part):
                    return part
            elif best_any is None and acceptable(part):
                best_any = part
        return None if any_mine else best_any

    @property
    def done(self) -> bool:
        # pop completed entries off the index tail until a live one is
        # found: each entry is discarded at most once across the app's
        # lifetime, so the check is amortized O(1) instead of a rescan
        idx = self._open()
        while idx:
            if self.parts[idx[-1]].done:
                idx.pop()
            else:
                return False
        return True

    @property
    def total_data_bytes(self) -> int:
        return sum(p.data_bytes for p in self.parts)


@dataclass
class Lease:
    part_id: int
    volunteer_id: str
    issued_at: float
    deadline: float


class LeaseTable:
    """TAIL's bookkeeping: part -> outstanding leases, with timeouts."""

    def __init__(self, timeout_s: float):
        self.timeout_s = timeout_s
        self.by_part: Dict[int, List[Lease]] = {}

    def grant(self, part_id: int, volunteer_id: str, now: float) -> Lease:
        lease = Lease(part_id, volunteer_id, now, now + self.timeout_s)
        self.by_part.setdefault(part_id, []).append(lease)
        return lease

    def release(self, part_id: int, volunteer_id: str) -> bool:
        ls = self.by_part.get(part_id, [])
        for i, l in enumerate(ls):
            if l.volunteer_id == volunteer_id:
                ls.pop(i)
                return True
        return False

    def expired(self, now: float) -> List[Lease]:
        out = []
        for ls in self.by_part.values():
            out.extend(l for l in ls if l.deadline <= now)
        return out

    def drop_volunteer(self, volunteer_id: str) -> List[int]:
        """Drop all leases of a volunteer; returns affected part ids."""
        parts = []
        for pid, ls in self.by_part.items():
            n0 = len(ls)
            ls[:] = [l for l in ls if l.volunteer_id != volunteer_id]
            if len(ls) != n0:
                parts.append(pid)
        return parts

    def active(self) -> Dict[int, list]:
        return {pid: ls for pid, ls in self.by_part.items() if ls}


def make_prime_app(app_id: str, host_id: str, lo: int, hi: int,
                   n_parts: int, *, app_bytes: int = 4096,
                   part_data_bytes: int = 4096, m_min: int = 1,
                   sim_time_per_number: float = 2.5e-3,
                   swarm: bool = False,
                   piece_bytes: int = 1 << 16,
                   image: Optional[bytes] = None) -> Application:
    """The paper's test application: prime search by exhaustion."""
    bounds = []
    step = (hi - lo) / n_parts
    for i in range(n_parts):
        a = int(lo + i * step)
        b = int(lo + (i + 1) * step) if i < n_parts - 1 else hi
        bounds.append((a, b))

    def run_fn(payload):
        a, b = payload
        return find_primes(a, b)

    def cost_fn(payload, speed):
        a, b = payload
        return (b - a) * sim_time_per_number / speed

    parts = [Part(i, bounds[i], data_bytes=part_data_bytes)
             for i in range(n_parts)]
    return Application(app_id, host_id, run_fn=run_fn, cost_fn=cost_fn,
                       app_bytes=len(image) if image is not None
                       else app_bytes,
                       parts=parts, m_min=m_min,
                       m_max=max(m_min, 1), swarm=swarm,
                       piece_bytes=piece_bytes, image=image)


def find_primes(lo: int, hi: int) -> list:
    """Exhaustion method, as in the paper's test application."""
    out = []
    for n in range(max(lo, 2), hi):
        if n % 2 == 0:
            if n == 2:
                out.append(n)
            continue
        i = 3
        prime = True
        while i * i <= n:
            if n % i == 0:
                prime = False
                break
            i += 2
        if prime:
            out.append(n)
    return out
