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
so every rank returns the whole batch's.  The serve steps also run
under `DEFAULT_RULES` (the residual's sequence split over ``model``).

The train step with a mesh (rules `DEFAULT_RULES` by default) runs SPMD
too: the state is this rank's blocks, the loss the global batch's, and
each leaf's gradient the psum of the ranks' partial gradients over the
axes the leaf is replicated on (`loss_and_grads`; `parallel.collectives`
says why the partials sum to the gradient).
"""
from __future__ import annotations

import contextlib
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
from repro_torch.spans import span, spanned


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


def _leaf_axes(cfg: ModelConfig, mesh, rules: ShardingRules
               ) -> Dict[str, Tuple[str, ...]]:
    """path -> the mesh axes each parameter leaf's block is cut over
    (`param_sharding`)."""
    return {path: tuple(a for e in shlib.param_sharding(mesh, s, rules)
                        for a in shlib.entry_axes(e))
            for path, s in tree_leaves_with_path(M.model_param_specs(cfg))}


def _partial_grads(cfg: ModelConfig, params: dict, batch: dict
                   ) -> Tuple[dict, Dict[str, torch.Tensor]]:
    """(metrics, {path: grad}) of `models.model.loss_fn`, on one device;
    under a mesh (an installed `sharding_ctx`) this rank's partial
    gradients, whose sum over the ranks that hold a leaf alike is the
    world size times the loss's gradient (`parallel.collectives`).  The
    f32 masters of rank >= 2 are cast to the compute dtype inside
    autograd, before any FSDP gather, so the gathers move the compute
    dtype and the grads land in f32 on the masters."""
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
        # the backward's kernels launch from autograd's device thread, not
        # under this span: it names the main thread's wait
        with span("train.backward"):
            gs = torch.autograd.grad(loss, [p for _, p in wrt],
                                     allow_unused=True)
    grads = {path: torch.zeros_like(p) if g is None else g
             for (path, p), g in zip(wrt, gs)}
    return {k: v.detach() for k, v in metrics.items()}, grads


def _tree(flat: Dict[str, torch.Tensor]) -> dict:
    out: dict = {}
    for path, t in flat.items():
        _set_path(out, path, t)
    return out


def _reduce_grads(grads: Dict[str, torch.Tensor], mesh,
                  leaf_axes: Dict[str, Tuple[str, ...]]
                  ) -> Dict[str, torch.Tensor]:
    """Partial gradients -> each leaf block's gradient: the psum over the
    mesh axes its leaf is not cut over (one psum of the concatenated
    leaves for each set of axes and dtype), over the world size."""
    from repro_torch.parallel import collectives as C
    names = tuple(mesh.mesh_dim_names)
    world = C.axis_size(names, mesh)
    buckets: Dict[tuple, List[str]] = {}
    for path, g in grads.items():
        rep = tuple(a for a in names if a not in leaf_axes[path])
        buckets.setdefault((rep, g.dtype), []).append(path)
    out = {}
    for (rep, _), paths in buckets.items():
        if rep:
            flat = C.psum(torch.cat([grads[p].reshape(-1) for p in paths]),
                          rep, mesh)
            parts = torch.split(flat, [grads[p].numel() for p in paths])
        else:
            parts = [grads[p] for p in paths]
        for p, g in zip(paths, parts):
            out[p] = g.view(grads[p].shape) / world
    return out


def loss_and_grads(cfg: ModelConfig, params: dict, batch: dict, mesh=None,
                   rules: Optional[ShardingRules] = None
                   ) -> Tuple[dict, dict]:
    """(metrics {"loss", "nll", "aux"}, grads): the gradient of
    `models.model.loss_fn` with respect to every floating-point leaf of
    ``params``.  With a mesh ``params`` are this rank's blocks
    (`models.convert.shard_params`), ``batch`` the whole batch (each
    rank takes its rows), the loss the global batch's and the grads this
    rank's blocks of the global gradient."""
    rules = rules or shlib.DEFAULT_RULES
    metrics, grads = _grads_on(cfg, params, batch, mesh, rules)
    if mesh is not None:
        grads = _reduce_grads(grads, mesh, _leaf_axes(cfg, mesh, rules))
    return metrics, _tree(grads)


def _grads_on(cfg: ModelConfig, params: dict, batch: dict, mesh, rules):
    """`_partial_grads` of ``batch`` on one device, or of this rank's rows
    of it under ``mesh``'s `sharding_ctx`."""
    if mesh is None:
        return _partial_grads(cfg, params, batch)
    B, S = batch_size(batch), _seq_len(batch)
    with shlib.sharding_ctx(mesh, rules, batch=B, seq=S):
        return _partial_grads(cfg, params, local_batch(batch, B, mesh, rules))


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
    before the optimizer, modelling the cross-pod DCN reduction leg.

    With a mesh (rules `DEFAULT_RULES` by default: FSDP over ``data``, TP
    and the sequence-split residual over ``model``) the step runs SPMD on
    this rank: ``state`` holds its blocks of the params, moments and
    error feedback, ``batch`` is the whole batch on every rank, the loss
    is the global batch's, each micro-step takes its rows of the global
    micro-batch, and the gradient norm and the int8 scale are the whole
    leaves'."""
    rules = rules or shlib.DEFAULT_RULES
    leaf_axes = _leaf_axes(cfg, mesh, rules) if mesh is not None else None

    @spanned("train.step")
    def train_step(state, batch):
        n_micro = max(cfg.micro_steps, 1)
        if n_micro == 1:
            metrics, grads = _grads_on(cfg, state["params"], batch, mesh,
                                       rules)
        else:
            # gradient accumulation over micro-batches, in f32
            grads = None
            nll = aux = 0.0
            for mb in _micro_batches(batch, n_micro):
                met, g = _grads_on(cfg, state["params"], mb, mesh, rules)
                if grads is None:
                    grads = {p: x.float() for p, x in g.items()}
                else:
                    for p, x in g.items():
                        grads[p] = grads[p] + x.float()
                nll = nll + met["nll"]
                aux = aux + met["aux"]
            grads = {p: x / n_micro for p, x in grads.items()}
            nll, aux = nll / n_micro, aux / n_micro
            metrics = {"loss": nll + cfg.router_aux_coef * aux, "nll": nll,
                       "aux": aux}
        if mesh is not None:
            grads = _reduce_grads(grads, mesh, leaf_axes)
        grads = _tree(grads)
        err_state = None
        if compress is not None and compress.scheme != "none":
            from repro_torch.optim.compression import compress_tree
            grads, err_state = compress_tree(grads, state.get("err"),
                                             compress, mesh=mesh,
                                             leaf_axes=leaf_axes)
        # a named span, so that a profile of the step can tell the
        # optimizer's kernels from the backward's
        with span("adamw_update"):
            new_params, new_opt, stats = adamw_update(
                opt_cfg, state["params"], grads, state["opt"],
                state["step"], mesh=mesh, leaf_axes=leaf_axes)
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


def _seq_len(batch: dict) -> int:
    return (batch["tokens"] if "tokens" in batch else batch["embeds"]
            ).shape[1]


def _serve_step(cfg: ModelConfig, fn, mesh, rules, return_logits: bool,
                name: Optional[str] = None):
    """A serve step of ``fn`` (`M.prefill` or `M.decode_step`): the
    greedy token of its last logits (and the logits, whole on every rank,
    with ``return_logits``), on one device (under the span ``name``, if
    given) or SPMD on a mesh."""
    if mesh is None:
        @torch.no_grad()
        def step(params, batch, caches):
            with span(name) if name else contextlib.nullcontext():
                last_logits, new_caches = fn(cfg, params, batch, caches)
                next_tok = torch.argmax(last_logits, dim=-1).to(torch.int32)
            if return_logits:
                return next_tok, new_caches, last_logits
            return next_tok, new_caches
        return step
    rules = rules or shlib.infer_rules(cfg)

    @torch.no_grad()
    def mesh_step(params, batch, caches):
        from repro_torch.models.layers import gather_logits, greedy_tokens
        from repro_torch.parallel.collectives import all_gather
        B, cache_len = caches["global"]
        if batch_size(batch) != B:
            raise ValueError(f"a batch of {batch_size(batch)} rows for "
                             f"caches cut for {B}")
        src = {"src_len": caches["src_len"]} if "src_len" in caches else {}
        with shlib.sharding_ctx(mesh, rules, batch=B, cache_len=cache_len,
                                seq=_seq_len(batch), **src):
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
    return _serve_step(cfg, M.prefill, mesh, rules, return_logits,
                       "serve.prefill")


def make_decode_step(cfg: ModelConfig, mesh=None,
                     rules: Optional[ShardingRules] = None,
                     return_logits: bool = False):
    return _serve_step(cfg, M.decode_step, mesh, rules, return_logits)
