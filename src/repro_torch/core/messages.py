"""Wire messages of the tracker/agent protocol (paper Figs. 1, 2, 4, 5)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


@dataclass
class AppInfo:
    """One row of the tracker's applications list."""
    app_id: str
    host_id: str
    d: float = 0.0
    p: float = 0.0
    w: float = 0.0
    n_parts: int = 0
    parts_remaining: int = 0
    updated_at: float = 0.0            # tracker timestamp (liveness)
    # --- piece-wise swarm extension (paper §V, "torrent-like") ---------- #
    # every node currently holding a complete, validated copy of the app
    # image; the tracker keeps this sorted by reported seeder load so
    # leechers default to the least-loaded holder
    seeders: Tuple[str, ...] = ()
    # metainfo for piece-wise image download (None => monolithic APP_DATA)
    manifest: Optional["object"] = None


@dataclass
class Msg:
    kind: str
    src: str
    payload: Dict[str, Any] = field(default_factory=dict)
    size_bytes: int = 256              # protocol overhead default


# message kinds
REGISTER = "REGISTER"          # agent -> server: list[AppInfo] of A_self
APP_LIST = "APP_LIST"          # server -> agent: full applications list
PING = "PING"                  # server -> agent availability check
PONG = "PONG"                  # agent -> server
STATUS = "STATUS"              # agent -> server: validated work + (d, w)
REQ = "REQ"                    # leecher -> host: request app + next part
APP_DATA = "APP_DATA"          # host -> leecher: app file + part payload
NO_WORK = "NO_WORK"            # host -> leecher: nothing left
RESULT = "RESULT"              # leecher -> host: R + measured (d, w)
RESULT_ACK = "RESULT_ACK"      # host -> leecher: valid / invalid
DROP_APP = "DROP_APP"          # server -> agents: A removed from list
BYE = "BYE"                    # agent -> server: clean leave

# --- piece-wise swarm extension (paper §V) ------------------------------ #
HAVE = "HAVE"                  # peer -> peers: verified-piece bitmask announce
PIECE_REQ = "PIECE_REQ"        # leecher -> holder: request one image piece
PIECE_DATA = "PIECE_DATA"      # holder -> leecher: piece payload + proof
SEEDER_UPDATE = "SEEDER_UPDATE"  # agent -> server (and relayed to seeders):
                                 # node completed the image, joins seeder set
MANIFEST_UPDATE = "MANIFEST_UPDATE"  # host -> server -> swarm: a new revision
                                 # of an app image (versioned PieceManifest);
                                 # bypasses the SEEDER_UPDATE push limiter —
                                 # version gossip must never go stale
PART_DONE = "PART_DONE"        # seeder <-> seeder: validated-part gossip
PEER_GONE = "PEER_GONE"        # server -> agents: volunteer left/died;
                                 # reclaim its leases immediately

# --- topology / P4P (ALTO cost map) ------------------------------------ #
COST_MAP = "COST_MAP"          # server -> agent on REGISTER: your island,
                               # endpoint costs to every island, and the
                               # node -> island directory

# --- choke scheduler + endgame (PieceExchange engine) ------------------- #
INTERESTED = "INTERESTED"      # leecher -> holder: I want pieces of app
CHOKE = "CHOKE"                # holder -> leecher: upload slot withdrawn
UNCHOKE = "UNCHOKE"            # holder -> leecher: upload slot granted
PIECE_CANCEL = "PIECE_CANCEL"  # leecher -> holder: drop my queued piece req
                               # (endgame reconciliation)
PART_CANCEL = "PART_CANCEL"    # seeder -> volunteer: part validated elsewhere,
                               # abort the leased execution
