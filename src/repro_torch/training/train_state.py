"""Train and serve state construction and step functions.

Counterpart of `repro.training.train_state`.  The train state
is nested dicts of tensors: ``{"params", "opt": {"m", "v"}, "step"}``
(``step`` a 0-d int32 tensor), and ``"err"`` with gradient compression's
error feedback.  `make_train_step` returns a function of ``(state,
batch)`` giving ``(new_state, metrics)``; it updates the state's tensors in
place (`optim.adamw.adamw_update`).  `make_prefill_step` and
`make_decode_step` return functions of ``(params, batch, caches)`` giving
``(next_tok, new_caches)`` exactly as the reference's do, with the greedy
next token as int32.

With a mesh (a `DeviceMesh` with ``mesh_dim_names``; rules
`infer_rules(cfg)` by default) the serve steps run SPMD on this rank:
``params`` are its blocks (`models.convert.shard_params`), ``caches``
its blocks from `models.model.init_caches(..., mesh=)`, ``batch`` the
whole batch on every rank (each rank takes its rows); the greedy token
is combined across the vocab shards and gathered over the batch axes,
so every rank returns the whole batch's.  The train step takes no mesh
yet.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.swarm_arrays import resolve_device
from repro_torch.models import model as M
from repro_torch.optim.adamw import (AdamWConfig, adamw_init_specs,
                                     adamw_update)
from repro_torch.parallel import sharding as shlib
from repro_torch.parallel.sharding import (ParamSpec, ShardingRules,
                                           _set_path, init_params,
                                           tree_leaves_with_path)

MESH_TRAIN = ("the sharded train step (FSDP gradients, the seq_act "
              "reduce-scatter, the int8 all-to-all's backward) comes with "
              "the next mesh slice (ROADMAP queue 1, item 5); train with "
              "mesh=None")


def train_state_specs(cfg: ModelConfig, opt: Optional[AdamWConfig] = None
                      ) -> dict:
    pspecs = M.model_param_specs(cfg)
    return {
        "params": pspecs,
        "opt": adamw_init_specs(pspecs),
        "step": ParamSpec((), (), torch.int32, init="zeros"),
    }


def init_train_state(seed: int, cfg: ModelConfig, device="cuda") -> dict:
    """Parameters drawn from ``seed`` on ``device`` ("cuda" by default,
    "cpu" on request), zero moments, step 0."""
    specs = train_state_specs(cfg)
    dev = resolve_device(device)
    return {"params": init_params(seed, specs["params"], device=dev),
            "opt": init_params(seed, specs["opt"], device=dev),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def loss_and_grads(cfg: ModelConfig, params: dict, batch: dict
                   ) -> Tuple[dict, dict]:
    """(metrics {"loss", "nll", "aux"}, grads): the gradient of
    `models.model.loss_fn` with respect to every floating-point leaf of
    ``params``.  The f32 masters of rank >= 2 are cast to the compute
    dtype inside autograd, so their grads land in f32 on the masters."""
    flat = [(path, p.detach().requires_grad_(p.is_floating_point()))
            for path, p in tree_leaves_with_path(params)]
    half: dict = {}
    for path, p in flat:
        if p.dtype == torch.float32 and p.ndim >= 2:
            p = p.to(cfg.act_dtype)
        _set_path(half, path, p)
    with torch.enable_grad():
        loss, metrics = M.loss_fn(cfg, half, batch)
        wrt = [(path, p) for path, p in flat if p.requires_grad]
        gs = torch.autograd.grad(loss, [p for _, p in wrt],
                                 allow_unused=True)
    grads: dict = {}
    for (path, p), g in zip(wrt, gs):
        _set_path(grads, path, torch.zeros_like(p) if g is None else g)
    return {k: v.detach() for k, v in metrics.items()}, grads


def _micro_batches(batch: dict, n: int) -> List[dict]:
    """Batch-major split into ``n`` micro-batches (mrope "positions" are
    (3, B, S): split on dim 1)."""
    out: List[Dict[str, torch.Tensor]] = [{} for _ in range(n)]
    for k, v in batch.items():
        dim = 1 if k == "positions" else 0
        for i, part in enumerate(torch.chunk(v, n, dim=dim)):
            if part.shape[dim] * n != v.shape[dim]:
                raise ValueError(f"batch {k}: {v.shape[dim]} rows do not "
                                 f"split into {n} micro-steps")
            out[i][k] = part
    return out


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, mesh=None,
                    rules: Optional[ShardingRules] = None, compress=None):
    """compress: optional optim.compression.CompressionConfig — applied to
    gradients (with persistent error-feedback state in the train state)
    before the optimizer, modelling the cross-pod DCN reduction leg.  A
    mesh raises (`MESH_TRAIN`)."""
    if mesh is not None:
        raise NotImplementedError(MESH_TRAIN)

    def train_step(state, batch):
        n_micro = max(cfg.micro_steps, 1)
        if n_micro == 1:
            metrics, grads = loss_and_grads(cfg, state["params"], batch)
        else:
            # gradient accumulation over micro-batches, in f32
            grads = None
            nll = aux = 0.0
            for mb in _micro_batches(batch, n_micro):
                met, g = loss_and_grads(cfg, state["params"], mb)
                if grads is None:
                    grads = {p: x.float() for p, x in
                             tree_leaves_with_path(g)}
                else:
                    for p, x in tree_leaves_with_path(g):
                        grads[p] = grads[p] + x.float()
                nll = nll + met["nll"]
                aux = aux + met["aux"]
            tree: dict = {}
            for p, x in grads.items():
                _set_path(tree, p, x / n_micro)
            grads = tree
            nll, aux = nll / n_micro, aux / n_micro
            metrics = {"loss": nll + cfg.router_aux_coef * aux, "nll": nll,
                       "aux": aux}
        err_state = None
        if compress is not None and compress.scheme != "none":
            from repro_torch.optim.compression import compress_tree
            grads, err_state = compress_tree(grads, state.get("err"),
                                             compress)
        # a named range, so that a profile of the step can tell the
        # optimizer's kernels from the backward's
        with torch.profiler.record_function("adamw_update"):
            new_params, new_opt, stats = adamw_update(
                opt_cfg, state["params"], grads, state["opt"],
                state["step"])
        metrics.update(stats)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        if err_state is not None:
            new_state["err"] = err_state
        return new_state, metrics
    return train_step


def local_batch(batch: dict, B: int, mesh, rules: ShardingRules) -> dict:
    """This rank's rows of a whole batch (mrope "positions" are (3, B,
    S): rows on dim 1)."""
    from repro_torch.parallel.collectives import local_chunk
    axes = shlib.entry_axes(shlib.logical_to_mesh_axes(
        mesh, (B,), ("batch",), rules)[0])
    return {k: local_chunk(v, axes, mesh, 1 if k == "positions" else 0)
            for k, v in batch.items()}


def batch_size(batch: dict) -> int:
    if "tokens" in batch:
        return batch["tokens"].shape[0]
    return batch["embeds"].shape[0]


def _serve_step(cfg: ModelConfig, fn, mesh, rules, return_logits: bool):
    """A serve step of ``fn`` (`M.prefill` or `M.decode_step`): the
    greedy token of its last logits (and the logits, whole on every rank,
    with ``return_logits``), on one device or SPMD on a mesh."""
    if mesh is None:
        @torch.no_grad()
        def step(params, batch, caches):
            last_logits, new_caches = fn(cfg, params, batch, caches)
            next_tok = torch.argmax(last_logits, dim=-1).to(torch.int32)
            if return_logits:
                return next_tok, new_caches, last_logits
            return next_tok, new_caches
        return step
    rules = rules or shlib.infer_rules(cfg)
    if rules.mesh_axes("seq_act"):
        raise NotImplementedError(
            "a sequence-parallel residual (seq_act) comes with the sharded "
            "train step (ROADMAP queue 1, item 5); serve under "
            "infer_rules(cfg)")

    @torch.no_grad()
    def mesh_step(params, batch, caches):
        from repro_torch.models.layers import gather_logits, greedy_tokens
        from repro_torch.parallel.collectives import all_gather
        B, cache_len = caches["global"]
        if batch_size(batch) != B:
            raise ValueError(f"a batch of {batch_size(batch)} rows for "
                             f"caches cut for {B}")
        with shlib.sharding_ctx(mesh, rules, batch=B, cache_len=cache_len):
            last_logits, new_caches = fn(cfg, params,
                                         local_batch(batch, B, mesh, rules),
                                         caches)
            tok = greedy_tokens(last_logits, cfg)
            axes = shlib.entry_axes(shlib.act_spec((B,), "batch")[0])
            tok = all_gather(tok, axes, mesh)
            if return_logits:
                return tok, new_caches, all_gather(
                    gather_logits(last_logits, cfg), axes, mesh)
            return tok, new_caches
    return mesh_step


def make_prefill_step(cfg: ModelConfig, mesh=None,
                      rules: Optional[ShardingRules] = None,
                      return_logits: bool = False):
    return _serve_step(cfg, M.prefill, mesh, rules, return_logits)


def make_decode_step(cfg: ModelConfig, mesh=None,
                     rules: Optional[ShardingRules] = None,
                     return_logits: bool = False):
    return _serve_step(cfg, M.decode_step, mesh, rules, return_logits)
