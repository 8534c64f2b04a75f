"""Model assembly: layer groups, parameter/cache spec trees, forward passes.

Counterpart of `repro.models.model`.  The model is a sequence of layer
groups (see `configs.base`); each group's parameters and caches are stacked
on a leading repeat axis, and the forward pass loops over that axis (the
reference scans it).  Parameters and caches are nested dicts of tensors
keyed by the reference's `ParamSpec` paths.

An encoder-decoder model (``cfg.is_encdec``) runs its encoder groups
bidirectionally over ``batch["enc_embeds"]`` (`encode`); each decoder
layer's cross attention projects the encoder output to k/v, which prefill
writes into the ``cross_k`` / ``cross_v`` caches and decode reads back (a
decode batch carries no ``enc_embeds``).

`prefill` and `decode_step` update the caches they are given in place and
return them with the new ``index``.  Under a mesh
(`parallel.sharding.sharding_ctx`, installed by the serve steps of
`training.train_state`) every tensor is this rank's local shard: the
batch rows, the param blocks of `param_sharding`, the cache blocks of
`logical_to_mesh_axes`; a leaf that the rules' FSDP axes split is
gathered to its TP block a layer at a time (`_gather_fsdp`), and the
caches carry ``"global"`` = (batch, cache_len), the global sizes their
blocks were cut from (`init_caches`), and an encoder-decoder's
``"src_len"``, the source length of its cross caches.  The
encoder-decoder family runs on a mesh as the decoder-only ones do: the
encoder's residual is split as the decoder's, over its own sequence
(`encode`), its output gathered to whole sequences, each decoder
layer's cross attention on its local heads
(`attention.cross_attention_block`), the cross caches in the rules'
layout.  The residual stream between blocks is in the
rules' ``("batch", "seq_act", None)`` layout (`layers.residual_spec`),
its sequence split over ``model`` under `DEFAULT_RULES`.  `loss_fn` is
the train objective; in train mode with ``cfg.remat`` "full" or "dots"
each repeat's layers run under activation checkpointing (the
reference's `jax.checkpoint` of its scan body), so the backward
recomputes them, the repeat's FSDP gather included; under "dots" the
outputs of the products with no batch dimensions are saved instead
(`_DotsPolicy`, the reference's `dots_with_no_batch_dims_saveable`).

With ``cfg.shared_blocks`` (the published Zamba2 block, `shared_block`)
the embedding's output ``x0`` goes down `run_groups` beside the
residual, and each layer that applies a shared block is told its
application number, which picks the block and is what the layer's own
adapter and linear stand for.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch.configs.base import GroupSpec, LayerSpec, ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.parallel import sharding as shlib
from repro_torch.parallel.sharding import (ParamSpec, init_params,
                                           tree_leaves_with_path,
                                           tree_map_specs)
from repro_torch.spans import span

# --------------------------------------------------------------------------- #
# Param specs
# --------------------------------------------------------------------------- #
def layer_param_specs(cfg: ModelConfig, lspec: LayerSpec,
                      decoder_cross: bool = False) -> dict:
    d: Dict[str, Any] = {}
    if lspec.mixer in ("attn", "attn_local"):
        d["ln_mixer"] = L.norm_spec(cfg.d_model)
        d["attn"] = attn_lib.attn_specs(cfg)
    elif lspec.mixer == "ssd":
        d["ln_mixer"] = L.norm_spec(cfg.d_model)
        d["ssd"] = ssm_lib.ssd_specs(cfg)
    if decoder_cross:
        d["ln_cross"] = L.norm_spec(cfg.d_model)
        d["cross"] = attn_lib.cross_attn_specs(cfg)
    if lspec.shared_attn and cfg.shared_blocks:
        # the application's own linear and MLP adapter (`shared_block`)
        d["shared_lin"] = ParamSpec((cfg.d_model, cfg.d_model),
                                    ("embed", None))
        d["adapter"] = L.adapter_specs(cfg)
    if lspec.mlp == "dense":
        d["ln_mlp"] = L.norm_spec(cfg.d_model)
        d["mlp"] = L.mlp_specs(cfg)
    elif lspec.mlp == "moe":
        d["ln_mlp"] = L.norm_spec(cfg.d_model)
        d["moe"] = moe_lib.moe_specs(cfg)
    return d


def _stack(tree, repeat: int):
    return tree_map_specs(
        lambda s: ParamSpec((repeat,) + s.shape, (None,) + s.logical,
                            s.dtype, s.init, s.scale), tree)


def group_param_specs(cfg: ModelConfig, g: GroupSpec,
                      decoder_cross: bool = False) -> dict:
    per_layer = {f"L{p}": layer_param_specs(cfg, ls, decoder_cross)
                 for p, ls in enumerate(g.layers)}
    return _stack(per_layer, g.repeat)


def _shared_cfg(cfg: ModelConfig) -> ModelConfig:
    return cfg.replace(num_heads=cfg.shared_attn_heads or cfg.num_heads,
                       num_kv_heads=cfg.shared_attn_kv_heads
                       or cfg.num_kv_heads)


def shared_attn_specs(cfg: ModelConfig) -> dict:
    """The shared attention over d_model, or with ``cfg.shared_blocks``
    the published Zamba2 blocks stacked on a leading axis: ``ln`` over
    concat(x, x0), ``attn`` from its 2 d_model to d_model, ``ln_mlp``,
    ``mlp``."""
    sub = _shared_cfg(cfg)
    if not cfg.shared_blocks:
        return {"ln": L.norm_spec(cfg.d_model),
                "attn": attn_lib.attn_specs(sub, heads=sub.num_heads,
                                            kv_heads=sub.num_kv_heads)}
    block = {"ln": L.norm_spec(2 * cfg.d_model),
             "attn": attn_lib.attn_specs(sub, heads=sub.num_heads,
                                         kv_heads=sub.num_kv_heads,
                                         d_in=2 * cfg.d_model),
             "ln_mlp": L.norm_spec(cfg.d_model),
             "mlp": L.mlp_specs(cfg)}
    return _stack(block, cfg.shared_blocks)


def model_param_specs(cfg: ModelConfig) -> dict:
    tree: Dict[str, Any] = {"embed": L.embed_specs(cfg)}
    tree["decoder"] = {f"g{i}": group_param_specs(cfg, g, cfg.is_encdec)
                       for i, g in enumerate(cfg.groups)}
    if cfg.is_encdec:
        tree["encoder"] = {f"g{i}": group_param_specs(cfg, g, False)
                           for i, g in enumerate(cfg.encoder_groups)}
        tree["encoder"]["enc_norm"] = L.norm_spec(cfg.d_model)
    if any(ls.shared_attn for g in cfg.groups for ls in g.layers):
        tree["shared_attn"] = shared_attn_specs(cfg)
    return tree


def count_params(cfg: ModelConfig, include_embed: bool = True,
                 active_only: bool = False) -> int:
    total = 0
    for path, s in tree_leaves_with_path(model_param_specs(cfg)):
        keys = path.split(".")
        n = 1
        for dim in s.shape:
            n *= int(dim)
        if not include_embed and ("embedding" in keys or "lm_head" in keys):
            continue
        if active_only and "moe" in keys and keys[-1] in ("wi_gate", "wi_up",
                                                         "wo"):
            # routed experts: scale by activated fraction
            n = n * max(cfg.experts_per_token, 1) // max(cfg.num_experts, 1)
        total += n
    return total


# --------------------------------------------------------------------------- #
# Cache specs
# --------------------------------------------------------------------------- #
def layer_cache_specs(cfg: ModelConfig, lspec: LayerSpec, batch: int,
                      cache_len: int, src_len: int = 0,
                      decoder_cross: bool = False) -> dict:
    d: Dict[str, Any] = {}
    if lspec.mixer == "attn":
        d.update(attn_lib.cache_specs(cfg, batch, cache_len))
    elif lspec.mixer == "attn_local":
        d.update(attn_lib.cache_specs(cfg, batch,
                                      min(cache_len, cfg.window_size)))
    elif lspec.mixer == "ssd":
        d.update(ssm_lib.ssd_cache_specs(cfg, batch))
    if lspec.shared_attn:
        kh = cfg.shared_attn_kv_heads or cfg.num_kv_heads
        cs = attn_lib.cache_specs(cfg, batch, cache_len, kv_heads=kh)
        d["shared_k"] = cs["k"]
        d["shared_v"] = cs["v"]
    if decoder_cross:
        d["cross_k"] = ParamSpec((batch, src_len, cfg.num_kv_heads,
                                  cfg.head_dim),
                                 ("batch", "kv_seq", "kv_heads", None),
                                 dtype=cfg.act_dtype, init="zeros")
        d["cross_v"] = d["cross_k"]
    return d


def cache_specs_tree(cfg: ModelConfig, batch: int, cache_len: int,
                     src_len: int = 0) -> dict:
    tree: Dict[str, Any] = {"decoder": {}}
    for i, g in enumerate(cfg.groups):
        per_layer = {f"L{p}": layer_cache_specs(cfg, ls, batch, cache_len,
                                                src_len, cfg.is_encdec)
                     for p, ls in enumerate(g.layers)}
        tree["decoder"][f"g{i}"] = _stack(per_layer, g.repeat)
    tree["index"] = ParamSpec((batch,), ("batch",), dtype=torch.int32,
                              init="zeros")
    return tree


def init_caches(cfg: ModelConfig, batch: int, cache_len: int,
                src_len: int = 0, *, mesh=None, rules=None, device="cuda"
                ) -> dict:
    """Zero caches for ``batch`` sequences of ``cache_len`` positions.
    With a mesh, this rank's blocks of them under the rules' layout
    (`logical_to_mesh_axes`; default `infer_rules(cfg)`), ``"global"`` =
    (batch, cache_len) and, for an encoder-decoder, ``"src_len"``."""
    tree = cache_specs_tree(cfg, batch, cache_len, src_len)
    if mesh is None:
        return init_params(0, tree, device=device)
    rules = rules or shlib.infer_rules(cfg)
    local = tree_map_specs(lambda s: ParamSpec(
        shlib.local_shape(s.shape, shlib.logical_to_mesh_axes(
            mesh, s.shape, s.logical, rules), mesh),
        s.logical, s.dtype, s.init), tree)
    out = init_params(0, local, device=device)
    out["global"] = (batch, cache_len)
    if cfg.is_encdec:
        out["src_len"] = src_len
    return out


# --------------------------------------------------------------------------- #
# Forward
# --------------------------------------------------------------------------- #
def shared_block(cfg: ModelConfig, blocks: dict, p: dict, x: torch.Tensor,
                 x0: torch.Tensor, app: int, *, mode: str, positions=None,
                 cache=None, index=None
                 ) -> Tuple[torch.Tensor, Optional[dict]]:
    """The published Zamba2 block at its application ``app`` (the running
    count of the model's layers that apply one): block ``app`` mod
    ``cfg.shared_blocks`` of the stacked ``blocks`` on concat(x, x0),
    RMS norm, attention with the layer's shared K/V cache, RMS norm, the
    gated MLP with the layer's adapter (``p["adapter"]``), no residual
    inside; then the layer's linear ``p["shared_lin"]``.  Returns (what
    the layer adds to its mixer's input, {"shared_k", "shared_v"} or
    None).  One device: the block has no mesh layout."""
    if shlib.current_mesh() is not None:
        raise NotImplementedError("the Zamba2 shared block under a mesh")
    with span("shared_block"):
        blk = _index_tree(blocks, app % cfg.shared_blocks)
        h = L.rms_norm(torch.cat([x, x0], dim=-1), blk["ln"], cfg.norm_eps)
        sub_cache = ({"k": cache["shared_k"], "v": cache["shared_v"]}
                     if cache and "shared_k" in cache else None)
        h, nc = attn_lib.attention_block(
            blk["attn"], h, _shared_cfg(cfg).replace(qk_norm=False),
            mode=mode, positions=positions, cache=sub_cache, index=index)
        h = L.rms_norm(h, blk["ln_mlp"], cfg.norm_eps)
        h = L.adapted_mlp(blk["mlp"], p["adapter"], h)
        h = torch.einsum("bsd,de->bse", h, p["shared_lin"].to(h.dtype))
    return h, ({"shared_k": nc["k"], "shared_v": nc["v"]} if nc else None)


def apply_layer(cfg: ModelConfig, lspec: LayerSpec, p: dict, x: torch.Tensor,
                aux: torch.Tensor, *, shared_params=None, mode: str,
                positions=None, cache=None, index=None, enc_kv=None,
                causal: bool = True, x0=None, app: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[dict]]:
    """One layer over the residual ``x``.  With ``cfg.shared_blocks`` a
    layer that applies the shared block (`shared_block`, its application
    number ``app``, ``x0`` the embedding's output) first adds the block's
    output to its mixer's input: x + mixer(norm(x + block(x, x0)))."""
    new_cache: Dict[str, Any] = {}
    mixer_in = x
    if lspec.shared_attn and cfg.shared_blocks:
        h, nc = shared_block(cfg, shared_params, p, x, x0, app, mode=mode,
                             positions=positions, cache=cache, index=index)
        mixer_in = x + h
        if nc:
            new_cache.update(nc)
    if lspec.mixer in ("attn", "attn_local"):
        h = L.rms_norm(mixer_in, p["ln_mixer"], cfg.norm_eps)
        sub_cache = ({"k": cache["k"], "v": cache["v"]}
                     if cache and "k" in cache else None)
        h, nc = attn_lib.attention_block(
            p["attn"], h, cfg, local=(lspec.mixer == "attn_local"), mode=mode,
            positions=positions, cache=sub_cache, index=index, causal=causal)
        x = x + h
        if nc:
            new_cache.update(nc)
    elif lspec.mixer == "ssd":
        h = L.rms_norm(mixer_in, p["ln_mixer"], cfg.norm_eps)
        sub_cache = ({k: cache[k] for k in ("ssm", "conv_x", "conv_b",
                                            "conv_c")}
                     if cache and "ssm" in cache else None)
        h, nc = ssm_lib.ssd_block(p["ssd"], h, cfg, mode=mode,
                                  cache=sub_cache)
        x = x + h
        if nc:
            new_cache.update(nc)

    if lspec.shared_attn and shared_params is not None \
            and not cfg.shared_blocks:
        h = L.rms_norm(x, shared_params["ln"], cfg.norm_eps)
        scfg = _shared_cfg(cfg).replace(qk_norm=False)
        sub_cache = ({"k": cache["shared_k"], "v": cache["shared_v"]}
                     if cache and "shared_k" in cache else None)
        h, nc = attn_lib.attention_block(
            shared_params["attn"], h, scfg, local=False, mode=mode,
            positions=positions, cache=sub_cache, index=index)
        x = x + h
        if nc:
            new_cache["shared_k"] = nc["k"]
            new_cache["shared_v"] = nc["v"]

    if enc_kv is not None and "cross" in p:
        h = L.rms_norm(x, p["ln_cross"], cfg.norm_eps)
        x = x + attn_lib.cross_attention_block(p["cross"], h, enc_kv, cfg)

    if lspec.mlp == "dense":
        h = L.rms_norm(x, p["ln_mlp"], cfg.norm_eps)
        x = x + L.mlp_apply(p["mlp"], h, tp_sp=cfg.tp_sp, d_ff=cfg.d_ff)
    elif lspec.mlp == "moe":
        h = L.rms_norm(x, p["ln_mlp"], cfg.norm_eps)
        h, a = moe_lib.moe_block(p["moe"], h, cfg)
        x = x + h
        aux = aux + a

    return x, aux, (new_cache or None)


def _fsdp_plan(spec_tree) -> Dict[str, tuple]:
    """path -> (param spec, TP spec) of each leaf that the current rules'
    FSDP axes split (none outside a mesh or without FSDP axes)."""
    mesh, rules = shlib.current_mesh(), shlib.current_rules()
    if mesh is None or not rules.fsdp_axes:
        return {}
    plan = {}
    for path, s in tree_leaves_with_path(spec_tree):
        ps = shlib.param_sharding(mesh, s, rules)
        ts = shlib.logical_to_mesh_axes(mesh, s.shape, s.logical, rules)
        if ps != ts:
            plan[path] = (ps, ts)
    return plan


def _gather_fsdp(tree, plan: Dict[str, tuple], prefix: str = ""):
    """``tree`` with each leaf of ``plan`` gathered from its param block
    to its TP block (an all-gather over the FSDP axes); the rest as is."""
    if not plan:
        return tree
    if isinstance(tree, dict):
        return {k: _gather_fsdp(v, plan, f"{prefix}.{k}" if prefix else k)
                for k, v in tree.items()}
    if prefix not in plan:
        return tree
    from repro_torch.parallel.collectives import relayout
    return relayout(tree, *plan[prefix], shlib.current_mesh())


def _index_tree(tree, r: int):
    if isinstance(tree, dict):
        return {k: _index_tree(v, r) for k, v in tree.items()}
    return tree[r]


def _layer_enc_kv(cfg: ModelConfig, lp: dict, lc: Optional[dict], enc_out,
                  mode: str):
    """A decoder layer's cross-attention (k, v, layout): from its cache in
    decode (the cache's layout), else projected from the encoder output
    (this rank's kv heads); None without cross attention."""
    if enc_out is None or "cross" not in lp:
        return None
    if mode == "decode" and lc is not None and "cross_k" in lc:
        return lc["cross_k"], lc["cross_v"], attn_lib.cross_cache_spec(cfg)
    return attn_lib.encode_cross_kv(lp["cross"], enc_out, cfg)


def _write_cross(cfg: ModelConfig, lc: dict, enc_kv) -> None:
    """Prefill: the cross k/v into the layer's ``cross_k`` / ``cross_v``
    caches, in place, in the caches' layout (under a mesh a relayout
    from the projections' kv heads: an all-to-all where the rules split
    the cache's sequence); their length is the source length they were
    made for."""
    from repro_torch.parallel.collectives import relayout
    k, v, src = enc_kv
    dst = attn_lib.cross_cache_spec(cfg, k.shape[1])
    for name, new in (("cross_k", k), ("cross_v", v)):
        new = relayout(new, src, dst, shlib.current_mesh())
        if lc[name].shape != new.shape:
            raise ValueError(f"{name} cache {tuple(lc[name].shape)} does not "
                             f"fit the encoder output's {tuple(new.shape)}: "
                             "make the caches with src_len = its length")
        lc[name].copy_(new)


def run_groups(cfg: ModelConfig, groups, params: dict, x: torch.Tensor, *,
               mode: str, positions=None, caches=None, index=None,
               shared_params=None, enc_out=None, causal: bool = True,
               x0=None
               ) -> Tuple[torch.Tensor, torch.Tensor, Optional[dict]]:
    """Run all layer groups, repeat by repeat.  Returns (x, aux, caches):
    the caches given, updated in place, or None without caches.
    ``enc_out`` (B, S_src, d), whole sequences, feeds the decoder layers'
    cross attention; ``x0``, the embedding's output, the Zamba2 shared
    blocks, each layer that applies one told its application number."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cross = cfg.is_encdec and enc_out is not None
    remat = mode == "train" and cfg.remat != "none"
    context_fn = _dots_contexts if cfg.remat == "dots" else noop_context_fn
    app = 0                   # shared-block applications so far
    for gi, g in enumerate(groups):
        gp = params[f"g{gi}"]
        gc = caches[f"g{gi}"] if caches is not None else None
        plan = (_fsdp_plan(group_param_specs(cfg, g, cross))
                if shlib.current_mesh() is not None else {})
        # a stacked leaf whose FSDP took the repeat axis: whole at once
        gp = _gather_fsdp(gp, {p: v for p, v in plan.items() if v[0][0]})
        plan = {p: (v[0][1:], v[1][1:]) for p, v in plan.items()
                if not v[0][0]}
        for r in range(g.repeat):
            if remat:
                # the repeat's FSDP gather runs inside the checkpoint, so
                # the backward's recompute gathers again
                x, aux = checkpoint(_remat_body(), cfg, g.layers,
                                    _index_tree(gp, r), plan, x, aux,
                                    shared_params, positions, enc_out,
                                    causal, x0, app, use_reentrant=False,
                                    context_fn=context_fn)
                app += sum(ls.shared_attn for ls in g.layers)
                continue
            p_slice = _gather_fsdp(_index_tree(gp, r), plan)
            c_slice = _index_tree(gc, r) if gc is not None else None
            for pidx, ls in enumerate(g.layers):
                key = f"L{pidx}"
                lc = c_slice[key] if c_slice is not None else None
                enc_kv = _layer_enc_kv(cfg, p_slice[key], lc, enc_out, mode)
                x, aux, nc = apply_layer(
                    cfg, ls, p_slice[key], x, aux,
                    shared_params=shared_params, mode=mode,
                    positions=positions, cache=lc, index=index,
                    enc_kv=enc_kv, causal=causal, x0=x0, app=app)
                app += ls.shared_attn
                if (lc is not None and "cross_k" in lc and enc_kv is not None
                        and mode == "prefill"):
                    _write_cross(cfg, lc, enc_kv)
                if lc is not None and nc:
                    for name, new in nc.items():
                        dst = lc[name]            # a view into the stack
                        if new.data_ptr() != dst.data_ptr():
                            dst.copy_(new)
    return x, aux, caches


def _remat_body():
    """`_repeat_body` for one checkpointed repeat, from its param blocks
    and FSDP plan: its first call is the forward, under a
    ``remat_forward`` span (`spans.span`: a profiler range while a
    profiler records); a later call is the recompute that the backward
    triggers, under ``remat_recompute``, so that a profile
    can tell its kernels from the backward node that unpacked the input.
    Both calls open a range, or neither (no profiler records): under
    remat "dots" the recompute may dispatch only the ops that the
    forward did."""
    calls = [0]

    def body(cfg, layers, p_local, plan, *args):
        calls[0] += 1
        name = "remat_forward" if calls[0] == 1 else "remat_recompute"
        with span(name):
            return _repeat_body(cfg, layers, _gather_fsdp(p_local, plan),
                                *args)
    return body


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)
_MATMUL_FNS = (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__)


def _no_batch_dims(func, args) -> bool:
    """Whether a torch-level product is a dot with no batch dimensions in
    the reference's sense (a `dot_general` whose dimension numbers name
    no batch dimension).  An einsum has one where a letter lies in every
    operand and in the output; a matmul where both operands carry batch
    dimensions; `torch.bmm` always.  The dispatcher cannot tell: an
    unbatched einsum reaches it as a `bmm` with a batch of 1, as does a
    batched one whose batch happens to be 1.  (The port's products are
    einsums, `@` and `torch.bmm`; any other is recomputed.)"""
    if func is torch.einsum:
        ins, out = args[0].replace(" ", "").split("->")
        ins = ins.split(",")
        return len(ins) > 1 and not set(out).intersection(*map(set, ins))
    if func in _MATMUL_FNS:
        return min(args[0].ndim, args[1].ndim) <= 2
    return False


class _DotsPolicy(TorchFunctionMode):
    """remat "dots": save the outputs of the products with no batch
    dimensions, recompute everything else (the reference's
    `jax.checkpoint_policies.dots_with_no_batch_dims_saveable`).  As a
    function mode it sees each product with its einsum equation and
    marks the matmul launches it dispatches; `policy` is the selective
    checkpoint's policy over those launches.  The kernels' custom ops,
    the collectives and the batched products (scores, experts) are
    recomputed, as a `pallas_call` or a batched `dot_general` is in the
    reference."""

    def __init__(self):
        super().__init__()
        self.depth = 0          # unbatched products in flight

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if not _no_batch_dims(func, args):
            return func(*args, **(kwargs or {}))
        self.depth += 1
        try:
            return func(*args, **(kwargs or {}))
        finally:
            self.depth -= 1

    def policy(self, ctx, op, *args, **kwargs):
        if self.depth and op in _MATMULS:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE


@contextlib.contextmanager
def _entered(*contexts):
    with contextlib.ExitStack() as stack:
        for c in contexts:
            stack.enter_context(c)
        yield


def _dots_contexts():
    """`checkpoint`'s ``context_fn`` under remat "dots": the forward and
    the recompute each run inside the marking function mode and their
    selective-checkpoint dispatch mode."""
    dots = _DotsPolicy()
    forward, recompute = create_selective_checkpoint_contexts(dots.policy)
    return _entered(dots, forward), _entered(dots, recompute)


def _repeat_body(cfg: ModelConfig, layers, p_slice: dict, x: torch.Tensor,
                 aux: torch.Tensor, shared_params, positions, enc_out,
                 causal: bool, x0=None, app: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One repeat of a group's layers in train mode (no caches): the unit
    that activation checkpointing saves the input of and recomputes
    (``app``: the shared-block applications before it)."""
    for pidx, ls in enumerate(layers):
        lp = p_slice[f"L{pidx}"]
        x, aux, _ = apply_layer(
            cfg, ls, lp, x, aux, shared_params=shared_params, mode="train",
            positions=positions, causal=causal,
            enc_kv=_layer_enc_kv(cfg, lp, None, enc_out, "train"), x0=x0,
            app=app)
        app += ls.shared_attn
    return x, aux


# --------------------------------------------------------------------------- #
# Top-level entry points
# --------------------------------------------------------------------------- #
def _inputs_to_x(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    if "embeds" in batch:
        return L.to_residual(batch["embeds"].to(cfg.act_dtype))
    return L.embed_tokens(params["embed"], batch["tokens"], cfg)


def _positions(cfg: ModelConfig, batch: dict, B: int, S: int, device,
               index=None) -> torch.Tensor:
    if "positions" in batch:
        return batch["positions"]
    if index is not None:
        pos = attn_lib.per_seq(index, B, device)[:, None]
    else:
        pos = torch.broadcast_to(torch.arange(S, device=device), (B, S))
    if cfg.mrope:
        pos = torch.broadcast_to(pos[None], (3,) + tuple(pos.shape))
    return pos


def encode(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """The encoder over ``batch["enc_embeds"]`` (B, S_src, d): its groups
    without a causal mask, then ``enc_norm``.  Under a mesh its residual
    lies in the decoder's layout over the source's own sequence (split
    over ``model`` under `DEFAULT_RULES`), and the output is gathered to
    this rank's rows, whole sequences, for the cross k/v."""
    x = batch["enc_embeds"].to(cfg.act_dtype)
    B, S = x.shape[0], x.shape[1]
    pos = torch.broadcast_to(torch.arange(S, device=x.device), (B, S))
    with shlib.with_dims(seq=S):
        x = L.to_residual(x)
        x, _, _ = run_groups(cfg, cfg.encoder_groups, params["encoder"], x,
                             mode="train", positions=pos, causal=False)
        x = L.rms_norm(x, params["encoder"]["enc_norm"], cfg.norm_eps)
        return L.block_input(x)


def backbone(cfg: ModelConfig, params: dict, batch: dict, *,
             mode: str = "train", caches=None, index=None):
    """Everything up to (but excluding) the LM head.  An encoder-decoder
    model encodes ``enc_embeds`` first; a decode batch without them reads
    the cross caches, and its ``enc_out`` is a (B, 1, d) zero stand-in."""
    enc_out = None
    if cfg.is_encdec:
        if mode != "decode" or "enc_embeds" in batch:
            enc_out = encode(cfg, params, batch)
        x = L.embed_tokens(params["embed"], batch["tokens"], cfg)
        if enc_out is None:
            enc_out = torch.zeros((x.shape[0], 1, cfg.d_model),
                                  dtype=cfg.act_dtype, device=x.device)
    else:
        x = _inputs_to_x(cfg, params, batch)
    # the rows and whole sequences of the batch (under a sequence-split
    # residual x holds a block of the sequence)
    B = x.shape[0]
    S = (batch["embeds"] if "embeds" in batch else batch["tokens"]).shape[1]
    positions = _positions(cfg, batch, B, S, x.device,
                           index if mode == "decode" else None)
    dec_caches = caches["decoder"] if caches is not None else None
    x, aux, new_dec = run_groups(cfg, cfg.groups, params["decoder"], x,
                                 mode=mode, positions=positions,
                                 caches=dec_caches, index=index,
                                 shared_params=params.get("shared_attn"),
                                 enc_out=enc_out, causal=True,
                                 x0=x if cfg.shared_blocks else None)
    new_caches = None
    if new_dec is not None:
        if index is not None:   # decode: advance each sequence's position
            new_idx = (attn_lib.per_seq(index, B, x.device)
                       + S).to(torch.int32)
        else:                    # prefill: every sequence sits at S
            new_idx = torch.full((B,), S, dtype=torch.int32, device=x.device)
        new_caches = {"decoder": new_dec, "index": new_idx}
        for key in ("global", "src_len"):
            if key in caches:
                new_caches[key] = caches[key]
    return x, aux, new_caches


def forward(cfg: ModelConfig, params: dict, batch: dict, *,
            mode: str = "train", caches=None, index=None
            ) -> Tuple[torch.Tensor, torch.Tensor, Optional[dict]]:
    """Returns (logits, aux_loss, new_caches)."""
    params = _gather_top(cfg, params)
    x, aux, new_caches = backbone(cfg, params, batch, mode=mode,
                                  caches=caches, index=index)
    x = L.block_input(x)
    if mode == "prefill":
        # only the last position's logits are needed to start decoding
        x = x[:, -1:]
    logits = L.lm_logits(params["embed"], x, cfg)
    return logits, aux, new_caches


def _gather_top(cfg: ModelConfig, params: dict) -> dict:
    """Under a mesh, ``params`` with the leaves outside the layer groups
    (the embedding and head, the shared attention, the encoder's final
    norm) gathered from their FSDP blocks once; ``params`` as is without
    one."""
    if shlib.current_mesh() is None:
        return params
    specs = model_param_specs(cfg)
    top = {k: v for k, v in specs.items() if k not in ("decoder", "encoder")}
    out = {**params, **_gather_fsdp({k: params[k] for k in top},
                                    _fsdp_plan(top))}
    if cfg.is_encdec:
        # the encoder's final norm; its groups gather in `run_groups`
        norm = {"enc_norm": specs["encoder"]["enc_norm"]}
        out["encoder"] = {**params["encoder"], **_gather_fsdp(
            {"enc_norm": params["encoder"]["enc_norm"]}, _fsdp_plan(norm))}
    return out


def loss_fn(cfg: ModelConfig, params: dict, batch: dict
            ) -> Tuple[torch.Tensor, dict]:
    """The train objective: mean token NLL (masked by ``loss_mask`` when
    the batch has one) plus the router's aux loss.  Returns (loss,
    {"loss", "nll", "aux"}).  Under a mesh ``params`` are this rank's
    blocks and ``batch`` its rows, and the loss is the global batch's,
    the same on every rank."""
    params = _gather_top(cfg, params)
    x, aux, _ = backbone(cfg, params, batch, mode="train")
    nll = L.lm_head_loss(params["embed"], x, batch["labels"], cfg,
                         batch.get("loss_mask"))
    loss = nll + cfg.router_aux_coef * aux
    return loss, {"loss": loss, "nll": nll, "aux": aux}


def prefill(cfg: ModelConfig, params: dict, batch: dict, caches
            ) -> Tuple[torch.Tensor, dict]:
    logits, _, new_caches = forward(cfg, params, batch, mode="prefill",
                                    caches=caches, index=None)
    return logits[:, -1], new_caches


def decode_step(cfg: ModelConfig, params: dict, batch: dict, caches
                ) -> Tuple[torch.Tensor, dict]:
    logits, _, new_caches = forward(cfg, params, batch, mode="decode",
                                    caches=caches, index=caches["index"])
    return logits[:, -1], new_caches
