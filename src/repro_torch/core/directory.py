"""Agent working-directory layout (paper §III.F, Fig. 3).

  <root>/<agent>/
    Seed/App/<app_id>/app.bin
    Seed/App/<app_id>/Data/Tracker        # TAIL's volunteer/lease log
    Seed/App/<app_id>/Result/<part>.res
    Leech/App/<app_id>/Data/Time          # TIME's working-time log
    Leech/App/<app_id>/Result/<part>.res  # temporary, dropped by STOP

All leech content is temporary: once an application finishes (or the host
vanishes), STOP removes the whole Leech/App/<app_id> subtree.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional


class AgentDirs:
    def __init__(self, root: str, agent_id: str):
        self.base = os.path.join(root, agent_id)
        os.makedirs(os.path.join(self.base, "Seed", "App"), exist_ok=True)
        os.makedirs(os.path.join(self.base, "Leech", "App"), exist_ok=True)

    # ---- seed side -------------------------------------------------------
    def seed_app(self, app_id: str, app_bytes: int,
                 image: Optional[bytes] = None) -> str:
        d = os.path.join(self.base, "Seed", "App", app_id)
        os.makedirs(os.path.join(d, "Data"), exist_ok=True)
        os.makedirs(os.path.join(d, "Result"), exist_ok=True)
        with open(os.path.join(d, "app.bin"), "wb") as f:
            f.write(image if image is not None
                    else b"\0" * min(app_bytes, 1 << 16))
        return d

    def save_seed_image(self, app_id: str, image: bytes) -> str:
        """Write a (reassembled) application image as this agent's Seed
        copy — the moment a leecher turns replica seeder."""
        return self.seed_app(app_id, len(image), image=image)

    def load_seed_image(self, app_id: str) -> Optional[bytes]:
        p = os.path.join(self.base, "Seed", "App", app_id, "app.bin")
        if not os.path.exists(p):
            return None
        with open(p, "rb") as f:
            return f.read()

    def tracker_log(self, app_id: str, line: str) -> None:
        d = os.path.join(self.base, "Seed", "App", app_id, "Data")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "Tracker"), "a") as f:
            f.write(line + "\n")

    def save_seed_result(self, app_id: str, part_id: int, result: Any) -> None:
        d = os.path.join(self.base, "Seed", "App", app_id, "Result")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"{part_id}.res"), "w") as f:
            json.dump(result, f)

    # ---- piece cache (paper §V swarm extension) --------------------------
    # Verified image pieces live under Leech/App/<app_id>/Pieces so a
    # volunteer can re-seed them mid-download; once the image completes the
    # pieces are reassembled into the agent's Seed copy (save_seed_image).
    def save_piece(self, app_id: str, piece_id: int, data: bytes) -> None:
        d = os.path.join(self.base, "Leech", "App", app_id, "Pieces")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"{piece_id}.piece"), "wb") as f:
            f.write(data)

    def load_piece(self, app_id: str, piece_id: int) -> Optional[bytes]:
        p = os.path.join(self.base, "Leech", "App", app_id, "Pieces",
                         f"{piece_id}.piece")
        if not os.path.exists(p):
            return None
        with open(p, "rb") as f:
            return f.read()

    def drop_piece(self, app_id: str, piece_id: int) -> None:
        """Remove one cached piece (a corrupt or foreign file found while
        rescanning the cache on agent restart)."""
        p = os.path.join(self.base, "Leech", "App", app_id, "Pieces",
                         f"{piece_id}.piece")
        try:
            os.remove(p)
        except OSError:
            pass

    def list_pieces(self, app_id: str) -> list:
        d = os.path.join(self.base, "Leech", "App", app_id, "Pieces")
        if not os.path.isdir(d):
            return []
        return sorted(int(f.split(".")[0]) for f in os.listdir(d)
                      if f.endswith(".piece"))

    def assemble_image(self, app_id: str, n_pieces: int) -> Optional[bytes]:
        """Join the cached pieces into the full image (None if any piece is
        missing); content verification is the caller's job."""
        parts = []
        for piece_id in range(n_pieces):
            data = self.load_piece(app_id, piece_id)
            if data is None:
                return None
            parts.append(data)
        return b"".join(parts)

    # ---- leech side ------------------------------------------------------
    def time_log(self, app_id: str, line: str) -> None:
        d = os.path.join(self.base, "Leech", "App", app_id, "Data")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "Time"), "a") as f:
            f.write(line + "\n")

    def save_leech_result(self, app_id: str, part_id: int, result: Any
                          ) -> None:
        d = os.path.join(self.base, "Leech", "App", app_id, "Result")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"{part_id}.res"), "w") as f:
            json.dump(result, f)

    def load_leech_result(self, app_id: str, part_id: int) -> Optional[Any]:
        p = os.path.join(self.base, "Leech", "App", app_id, "Result",
                         f"{part_id}.res")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return json.load(f)

    def drop_leech_app(self, app_id: str) -> None:
        d = os.path.join(self.base, "Leech", "App", app_id)
        if os.path.isdir(d):
            shutil.rmtree(d, ignore_errors=True)
