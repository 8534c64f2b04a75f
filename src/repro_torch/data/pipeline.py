"""Piece/lease-based data pipeline.

Every global batch is a *piece* with (d, w) units, leased from the
JobCoordinator exactly the way a volunteer leases a part (REQ/DIST/TAIL):
a straggling or dead host's lease expires and the piece is re-dispatched,
so batch delivery is exactly-once-per-step even under churn.  The pipeline
state (next piece id, epoch) is part of the checkpoint, making input
resumable and deterministic.

Counterpart of `repro.data.pipeline`: plain Python, the same code.
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.cluster.coordinator import JobCoordinator


class SyntheticTokens:
    """Deterministic synthetic LM tokens (hash-seeded, reproducible)."""

    def __init__(self, vocab_size: int, seed: int = 0):
        self.vocab = vocab_size
        self.seed = seed

    def piece(self, piece_id: int, batch: int, seq: int) -> dict:
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + piece_id) % (2**31 - 1))
        toks = rng.randint(0, self.vocab, size=(batch, seq + 1),
                           dtype=np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class TokenFileStore:
    """Flat binary token shards on disk (one uint32 stream per shard)."""

    MAGIC = b"RTOK1\0"

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def write_shard(self, shard_id: int, tokens: np.ndarray) -> str:
        path = os.path.join(self.root, f"shard_{shard_id:05d}.tok")
        with open(path, "wb") as f:
            f.write(self.MAGIC)
            f.write(struct.pack("<q", tokens.size))
            f.write(tokens.astype(np.uint32).tobytes())
        return path

    def read_shard(self, shard_id: int) -> np.ndarray:
        path = os.path.join(self.root, f"shard_{shard_id:05d}.tok")
        with open(path, "rb") as f:
            magic = f.read(len(self.MAGIC))
            assert magic == self.MAGIC, "bad token shard"
            (n,) = struct.unpack("<q", f.read(8))
            return np.frombuffer(f.read(4 * n), dtype=np.uint32)

    def shards(self) -> List[int]:
        out = []
        for fn in sorted(os.listdir(self.root)):
            if fn.startswith("shard_") and fn.endswith(".tok"):
                out.append(int(fn[6:11]))
        return out

    def piece(self, piece_id: int, batch: int, seq: int,
              vocab_size: int) -> dict:
        shards = self.shards()
        tokens = self.read_shard(shards[piece_id % len(shards)])
        need = batch * (seq + 1)
        start = (piece_id * need) % max(tokens.size - need, 1)
        window = tokens[start:start + need]
        if window.size < need:
            window = np.pad(window, (0, need - window.size))
        toks = (window.astype(np.int64) % vocab_size).astype(np.int32)
        toks = toks.reshape(batch, seq + 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@dataclass
class PipelineState:
    next_piece: int = 0
    epoch: int = 0
    delivered: int = 0


class LeasedBatchPipeline:
    """Coordinator-backed batch delivery with lease fault tolerance."""

    def __init__(self, source, batch: int, seq: int,
                 coordinator: Optional[JobCoordinator] = None,
                 pieces_per_epoch: int = 1 << 16,
                 member_id: str = "pod0",
                 token_bytes: int = 4):
        self.source = source
        self.batch = batch
        self.seq = seq
        self.coord = coordinator or JobCoordinator(lease_timeout_s=300.0)
        self.coord.join(member_id)
        self.member = member_id
        self.pieces_per_epoch = pieces_per_epoch
        self.state = PipelineState()
        self._d = batch * (seq + 1) * token_bytes

    def _submit_next(self) -> int:
        pid = self.state.next_piece
        self.state.next_piece += 1
        if self.state.next_piece >= self.pieces_per_epoch:
            self.state.next_piece = 0
            self.state.epoch += 1
        return self.coord.submit("data", {"piece": pid,
                                          "epoch": self.state.epoch},
                                 d_bytes=self._d)

    def next_batch(self) -> Tuple[int, dict]:
        """Lease the next piece and materialise its batch."""
        self.coord.expire_leases()
        item = self.coord.request(self.member)
        if item is None:
            self._submit_next()
            item = self.coord.request(self.member)
        piece_id = item.payload["piece"]
        batch = self.source.piece(piece_id, self.batch, self.seq)
        return item.item_id, batch

    def complete(self, item_id: int, elapsed_s: float = 0.0) -> None:
        self.coord.complete(self.member, item_id, elapsed_s=elapsed_s)
        self.state.delivered += 1

    # ---- checkpointable state -------------------------------------------
    def state_dict(self) -> dict:
        return {"next_piece": self.state.next_piece,
                "epoch": self.state.epoch,
                "delivered": self.state.delivered}

    def load_state_dict(self, d: dict) -> None:
        self.state = PipelineState(**d)
