"""Continuous-batching serving engine with (d, p, w)-aware admission.

Counterpart of `repro.serving.engine`.  Requests are the serving analogue
of the paper's applications: each carries
  d — prompt+generation bytes,
  w — measured decode seconds (running average per bucket),
  p — how many requests of this bucket were served.
The engine publishes these units (like the tracker's list) and admission
prefers short-w buckets when the queue saturates — the volunteer's
"judge by d and w" heuristic as a scheduler policy.

Execution: prompts are fed token by token through the decode step of the
whole slot batch; finished slots are refilled from the queue (continuous
batching).  The KV cache is one fixed-size pool tensor per layer, slots
are rows.  `from_swarm` cold-starts a replica from the checkpoint swarm.

With a mesh every rank of it builds the engine and runs every tick: the
params are cut to this rank's blocks by `infer_rules(cfg)`, the caches
are its blocks of the rules' layout (slots over the batch axes,
sequences over ``kv_seq``), and each decode step runs SPMD over the
whole slot batch (`training.train_state.make_decode_step(cfg, mesh)`).
A prefill microstep steps every slot there; the other slots' recurrent
states (SSM and conv caches) are put back afterwards, and their KV
writes land on their current position with the token they will be fed
next, which their own next step rewrites alike.
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.swarm_arrays import resolve_device
from repro_torch.models import model as M
from repro_torch.parallel import sharding as shlib
from repro_torch.parallel.sharding import ParamSpec, tree_leaves_with_path
from repro_torch.training.train_state import make_decode_step


@dataclass
class Request:
    req_id: int
    prompt: np.ndarray                 # (S,) int32
    max_new: int = 16
    arrived: float = 0.0
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False
    started: float = 0.0
    finished: float = 0.0


@dataclass
class ServeConfig:
    slots: int = 4                     # concurrent sequences
    max_len: int = 256                 # cache length
    prefill_bucket: int = 64


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, sc: ServeConfig,
                 mesh=None, device="cuda"):
        """``params`` must lie on ``device`` ("cuda" by default, "cpu"
        for the plain PyTorch paths).  With a ``mesh`` (a `DeviceMesh`
        whose every rank builds this engine) ``params`` is the whole tree
        (tensors or numpy arrays), and each rank keeps its blocks."""
        self.cfg = cfg
        self.sc = sc
        self.device = resolve_device(device)
        self.mesh = mesh
        self.rules = shlib.infer_rules(cfg)
        if mesh is not None:
            from repro_torch.models.convert import shard_params
            params = shard_params(params, M.model_param_specs(cfg), mesh,
                                  self.rules, device=self.device)
        self.params = params
        # the checkpoint's `extra` dict when the params came from the
        # swarm (from_swarm); None for directly-constructed engines
        self.restore_extra: Optional[dict] = None
        self.queue: collections.deque = collections.deque()
        self.active: Dict[int, Request] = {}
        self.slot_req: List[Optional[int]] = [None] * sc.slots
        self.metrics = {"p": collections.Counter(),
                        "w": collections.defaultdict(float),
                        "d": collections.defaultdict(float)}
        self._init_cache()
        self._decode = make_decode_step(cfg, mesh, self.rules)
        self._next_id = 0

    @classmethod
    def from_swarm(cls, cfg: ModelConfig, template, sc: ServeConfig, *,
                   agent, app_id: str, workdir=None, mesh=None,
                   pod_axis: str = "pod", device="cuda") -> "ServingEngine":
        """Cold-start a replica from the distribution swarm.

        The replica's `agent` leeched the checkpoint Application like any
        other volunteer; the moment its piece set completes
        (`app_id in agent.images`) this reassembles the step image,
        re-hashes its content against the manifest and restores the
        params into `template`'s structure (tensors or `ParamSpec`s) on
        ``device``.  Raises if the piece set is still incomplete (the
        ready gate).

        With a `DeviceMesh` that has ``pod_axis``, every rank of that axis
        calls this: rank 0 (the seeder) holds the agent and restores from
        it, the other ranks pass ``agent=None`` and receive the params
        (and the checkpoint's ``extra``) over the `weight_torrent` ring,
        so only one host per pod pulls from the swarm.  Each rank then
        builds its engine on ``device``.  A mesh whose other axes have
        more than one rank would shard the engine, which the port does
        not do yet, and raises."""
        from repro_torch.checkpoint.store import pod_restore
        from repro_torch.checkpoint.swarm_restore import restore_from_agent
        sharded = any(size > 1 for name, size in
                      shlib.axis_sizes(mesh).items() if name != pod_axis)
        dev = resolve_device(device)
        template = _on_device(template, dev)
        params, extra = pod_restore(
            lambda: restore_from_agent(agent, app_id, template,
                                       workdir=workdir, device=dev),
            template, mesh, pod_axis, dev)
        eng = cls(cfg, params, sc, mesh=mesh if sharded else None,
                  device=dev)
        eng.restore_extra = extra
        return eng

    def _init_cache(self):
        self.caches = M.init_caches(self.cfg, self.sc.slots, self.sc.max_len,
                                    mesh=self.mesh, rules=self.rules,
                                    device=self.device)
        # the slots whose cache rows this rank holds
        self.rows = np.arange(self.sc.slots)
        if self.mesh is not None:
            from repro_torch.parallel.collectives import local_chunk
            axes = shlib.entry_axes(shlib.logical_to_mesh_axes(
                self.mesh, (self.sc.slots,), ("batch",), self.rules)[0])
            self.rows = local_chunk(torch.arange(self.sc.slots), axes,
                                    self.mesh, 0).numpy()
        self.positions = np.zeros(self.sc.slots, np.int64)
        self.tokens = np.zeros((self.sc.slots, 1), np.int32)

    def submit(self, prompt: np.ndarray, max_new: int = 16) -> int:
        rid = self._next_id
        self._next_id += 1
        req = Request(rid, np.asarray(prompt, np.int32), max_new,
                      arrived=time.monotonic())
        self.queue.append(req)
        return rid

    def _bucket(self, req: Request) -> int:
        b = self.sc.prefill_bucket
        return ((len(req.prompt) + b - 1) // b) * b

    def _admit(self) -> None:
        """Fill free slots; prefer short-w buckets under saturation."""
        free = [i for i, r in enumerate(self.slot_req) if r is None]
        if not free or not self.queue:
            return
        pending = sorted(
            self.queue,
            key=lambda r: self.metrics["w"].get(self._bucket(r), 0.0))
        for slot in free:
            if not pending:
                break
            req = pending.pop(0)
            self.queue.remove(req)
            self._prefill_into_slot(slot, req)

    def _prefill_into_slot(self, slot: int, req: Request) -> None:
        """Sequential prefill through the decode step (slot-local)."""
        req.started = time.monotonic()
        self.active[req.req_id] = req
        self.slot_req[slot] = req.req_id
        # reset this slot's position; feed prompt tokens one step at a time
        # through the shared decode path (slot-granular continuous batching;
        # a bucketed prefill graph is the natural next optimisation).
        self.positions[slot] = 0
        self._reset_slot(slot)
        toks = req.prompt
        for t in toks[:-1]:
            self.tokens[slot, 0] = int(t)
            self._step_decode(only_slot=slot)
        self.tokens[slot, 0] = int(toks[-1])

    def _reset_slot(self, slot: int) -> None:
        """Zero a slot's rows of every cache.  The SSM and conv states are
        recurrent: a new request must not start from the last one's."""
        if slot not in self.rows:
            return
        row = int(np.nonzero(self.rows == slot)[0][0])
        for _, leaf in tree_leaves_with_path(self.caches["decoder"]):
            leaf[:, row].zero_()

    def _step_decode(self, only_slot: Optional[int] = None) -> np.ndarray:
        """One decode step of every slot, or with ``only_slot`` of that
        slot alone (a prefill microstep) on views of its cache rows, which
        the step updates in place: the other slots' recurrent states must
        not advance."""
        if self.mesh is not None:
            return self._step_decode_mesh(only_slot)
        rows = (slice(None) if only_slot is None
                else slice(only_slot, only_slot + 1))
        pos = self.positions[rows]
        dev = self.device
        batch = {"tokens": torch.as_tensor(self.tokens[rows], device=dev)}
        if self.cfg.mrope:
            p3 = np.broadcast_to(pos[None, :, None],
                                 (3, len(pos), 1)).astype(np.int32)
            batch["positions"] = torch.as_tensor(p3, device=dev)
        caches = {"decoder": _rows(self.caches["decoder"], rows),
                  # per-slot positions: each sequence writes/masks at its
                  # own index
                  "index": torch.as_tensor(pos.astype(np.int32), device=dev)}
        next_tok, _ = self._decode(self.params, batch, caches)
        self.positions[rows] += 1
        return next_tok.cpu().numpy()

    def _step_decode_mesh(self, only_slot: Optional[int]) -> np.ndarray:
        """`_step_decode` SPMD over the whole slot batch; for a prefill
        microstep the other slots' recurrent states are put back."""
        dev = self.device
        batch = {"tokens": torch.as_tensor(self.tokens, device=dev)}
        if self.cfg.mrope:
            p3 = np.broadcast_to(self.positions[None, :, None],
                                 (3, self.sc.slots, 1)).astype(np.int32)
            batch["positions"] = torch.as_tensor(p3, device=dev)
        keep = {}
        if only_slot is not None:
            keep = {path: leaf.clone() for path, leaf in
                    tree_leaves_with_path(self.caches["decoder"])
                    if path.rsplit(".", 1)[-1] in RECURRENT}
        self.caches["index"] = torch.as_tensor(
            self.positions[self.rows].astype(np.int32), device=dev)
        next_tok, _ = self._decode(self.params, batch, self.caches)
        if only_slot is None:
            self.positions += 1
            return next_tok.cpu().numpy()
        others = torch.as_tensor(self.rows != only_slot, device=dev)
        for path, leaf in tree_leaves_with_path(self.caches["decoder"]):
            if path in keep:
                leaf[:, others] = keep[path][:, others]
        self.positions[only_slot] += 1
        return next_tok.cpu().numpy()

    def step(self) -> int:
        """One engine tick: admit, decode the full batch, retire finished."""
        self._admit()
        if not self.active:
            return 0
        t0 = time.monotonic()
        nxt = self._step_decode()
        dt = time.monotonic() - t0
        produced = 0
        for slot, rid in enumerate(self.slot_req):
            if rid is None:
                continue
            req = self.active[rid]
            tok = int(nxt[slot])
            req.out_tokens.append(tok)
            self.tokens[slot, 0] = tok
            produced += 1
            if len(req.out_tokens) >= req.max_new:
                req.done = True
                req.finished = time.monotonic()
                b = self._bucket(req)
                self.metrics["p"][b] += 1
                self.metrics["w"][b] = (
                    0.8 * self.metrics["w"].get(b, dt) + 0.2 *
                    (req.finished - req.started))
                self.metrics["d"][b] += 4.0 * (len(req.prompt)
                                               + len(req.out_tokens))
                self.slot_req[slot] = None
                del self.active[rid]
        return produced

    def run_until_drained(self, max_ticks: int = 10_000) -> List[Request]:
        done: List[Request] = []
        seen = set()
        for _ in range(max_ticks):
            if not self.queue and not self.active:
                break
            self.step()
        return done

    def published_units(self) -> dict:
        """The tracker-style (d, p, w) listing per prompt bucket."""
        return {b: {"d": self.metrics["d"][b], "p": self.metrics["p"][b],
                    "w": self.metrics["w"][b]}
                for b in self.metrics["p"]}


# the cache leaves that carry a sequence's recurrent state
RECURRENT = ("ssm", "conv_x", "conv_b", "conv_c")


def _on_device(template, dev: torch.device):
    """The template with each tensor leaf that lies off ``dev`` replaced
    by a `ParamSpec` of its shape and dtype, so that the restore lands
    every leaf on the engine's device."""
    if isinstance(template, dict):
        return {k: _on_device(v, dev) for k, v in template.items()}
    if isinstance(template, torch.Tensor) and template.device != dev:
        return ParamSpec(tuple(template.shape),
                         (None,) * template.dim(), template.dtype)
    return template


def _rows(tree, rows: slice):
    """Views of the batch rows of a stacked cache tree (batch is dim 1)."""
    if isinstance(tree, dict):
        return {k: _rows(v, rows) for k, v in tree.items()}
    return tree[:, rows]
