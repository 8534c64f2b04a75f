"""Production train loop wiring the paper's machinery into training.

Per step:
  1. lease a data piece from the coordinator (REQ),
  2. the train step on the device,
  3. complete the lease with the measured (d, w) units (STAT),
  4. heartbeat; periodic sentinel-batch SDC vote; periodic async checkpoint.

Failure handling: dead member -> leases return to queue + elastic resize
plan.

Counterpart of `repro.training.trainer`, on one device (``device="cuda"``
by default, "cpu" on request) or SPMD over a mesh (``mesh=``, a
`DeviceMesh`; every rank runs the same Trainer).  On the card the step
ends in `torch.cuda.synchronize`, so a step's ``w_s`` is its own time
and not the time to enqueue it.

On a mesh the state is this rank's blocks (`models.convert.shard_params`
under `DEFAULT_RULES`): a fresh state is drawn
whole from the seed and cut; a resume restores the whole step through
`CheckpointStore.restore_distributed` and cuts it; a save gathers the
blocks (`models.convert.gather_params`, a collective) and rank 0 writes
the image a single device would write of the same state.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint.store import CheckpointStore, async_save
from repro_torch.cluster.coordinator import JobCoordinator
from repro_torch.cluster.elastic import plan_resize
from repro_torch.cluster.sdc import SDCValidator
from repro_torch.configs.base import ModelConfig
from repro_torch.core.swarm_arrays import resolve_device
from repro_torch.data.pipeline import LeasedBatchPipeline, SyntheticTokens
from repro_torch.models.model import model_param_specs
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel.sharding import DEFAULT_RULES
from repro_torch.training.train_state import (init_train_state,
                                              make_train_step,
                                              train_state_specs)


@dataclass
class TrainerConfig:
    batch: int = 8
    seq: int = 128
    steps: int = 50
    ckpt_every: int = 25
    sdc_every: int = 0            # 0 = off
    sdc_m_min: int = 2
    ckpt_dir: Optional[str] = None
    member_id: str = "pod0"
    log_every: int = 10
    grad_compress: str = "none"   # "none" | "int8" | "topk" (cross-pod leg)


class Trainer:
    def __init__(self, cfg: ModelConfig, opt: AdamWConfig,
                 tc: TrainerConfig, mesh=None, source=None, device="cuda"):
        self.cfg = cfg
        self.opt = opt
        self.tc = tc
        self.mesh = mesh
        self.rules = DEFAULT_RULES
        self.device = resolve_device(device)
        self.coord = JobCoordinator(lease_timeout_s=600.0)
        self.pipeline = LeasedBatchPipeline(
            source or SyntheticTokens(cfg.vocab_size), tc.batch, tc.seq,
            coordinator=self.coord, member_id=tc.member_id)
        self.sdc = SDCValidator(m_min=tc.sdc_m_min, every_steps=tc.sdc_every)
        self.store = (CheckpointStore(tc.ckpt_dir) if tc.ckpt_dir else None)
        compress = None
        if tc.grad_compress != "none":
            from repro_torch.optim.compression import CompressionConfig
            compress = CompressionConfig(scheme=tc.grad_compress)
        self.step_fn = make_train_step(cfg, opt, mesh, self.rules,
                                       compress=compress)
        self.state = None
        self.history: List[dict] = []
        self._ckpt_threads: List = []

    # ------------------------------------------------------------------ #
    def init(self, seed: int = 0) -> None:
        """Resume from the store's latest step (the pipeline state with
        it; ``seed`` is then unused), else draw a fresh state; on a mesh,
        cut either to this rank's blocks."""
        if self.store is not None and self.store.latest_step() is not None:
            state, extra = self.store.restore_distributed(
                train_state_specs(self.cfg), self.mesh, device=self.device)
            if "pipeline" in extra:
                self.pipeline.load_state_dict(extra["pipeline"])
        else:
            state = init_train_state(seed, self.cfg, device=self.device)
        self.state = self._cut(state)

    def _map_trees(self, state: dict, fn) -> dict:
        """``state`` with ``fn`` applied to each parameter-shaped tree
        (params, the moments, the error feedback), ``step`` as is."""
        out = {"params": fn(state["params"]),
               "opt": {k: fn(state["opt"][k]) for k in ("m", "v")},
               "step": state["step"]}
        if "err" in state:
            out["err"] = fn(state["err"])
        return out

    def _cut(self, state: dict) -> dict:
        """A whole state as this rank's blocks (as is without a mesh)."""
        if self.mesh is None:
            return state
        from repro_torch.models.convert import shard_params
        specs = model_param_specs(self.cfg)
        return self._map_trees(state, lambda t: shard_params(
            t, specs, self.mesh, self.rules, device=self.device))

    def _to_save(self):
        """The whole state to write, on the rank that writes it (None on
        the others): on a mesh the blocks gathered, a collective."""
        if self.mesh is None:
            return self.state
        from repro_torch.models.convert import gather_params
        specs = model_param_specs(self.cfg)
        whole = self._map_trees(self.state, lambda t: gather_params(
            t, specs, self.mesh, self.rules))
        return whole if dist.get_rank() == 0 else None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self) -> List[dict]:
        assert self.state is not None, "call init() first"
        start = int(self.state["step"])
        for _ in range(start, self.tc.steps):
            t0 = time.monotonic()
            item_id, host_batch = self.pipeline.next_batch()
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in host_batch.items()}
            self.state, metrics = self.step_fn(self.state, batch)
            self._sync()
            loss = float(metrics["loss"])
            elapsed = time.monotonic() - t0
            self.pipeline.complete(item_id, elapsed_s=elapsed)
            self.coord.beat(self.tc.member_id)
            step = int(self.state["step"])
            rec = {"step": step, "loss": loss, "w_s": elapsed,
                   "d_bytes": self.pipeline._d}
            self.history.append(rec)
            # sentinel SDC vote: in a multi-pod job, each replica group
            # offers its fingerprint; single-controller runs degenerate to
            # the self-consistency case and are exercised in tests.
            if self.sdc.due(step):
                self.sdc.offer(step, self.tc.member_id, metrics)
            if self.store is not None and step % self.tc.ckpt_every == 0:
                tree = self._to_save()
                if tree is not None:
                    self._ckpt_threads.append(async_save(
                        self.store, step, tree,
                        extra={"pipeline": self.pipeline.state_dict()}))
            if self.tc.log_every and step % self.tc.log_every == 0:
                print(f"step {step}: loss={loss:.4f} w={elapsed:.2f}s",
                      flush=True)
        self.finish()
        return self.history

    def finish(self) -> None:
        """Join the background saves, then save the last step unless a
        periodic save already holds it (on a mesh every rank calls this:
        the save gathers, and a barrier ends it)."""
        if self.store is not None:
            for th in self._ckpt_threads:
                th.join(timeout=60.0)
            step = int(self.state["step"])
            if step % self.tc.ckpt_every != 0:
                tree = self._to_save()
                if tree is not None:
                    self.store.save(step, tree, extra={
                        "pipeline": self.pipeline.state_dict()})
            if self.mesh is not None:
                # no rank reads the store before rank 0 has written it
                dist.barrier()

    # failure-path helpers (exercised by tests) -------------------------- #
    def on_member_dead(self, member_id: str, alive_pods: int):
        self.coord._on_dead(member_id)
        return plan_resize(alive_pods)
