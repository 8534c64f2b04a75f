"""Declarative parameters and the logical-axis sharding rules.

Counterpart of `repro.parallel.sharding`.  A model's parameters (and its
caches) are nested dicts whose leaves are `ParamSpec`s; `init_params`
turns such a tree into the same nested dicts of tensors.  Leaves are
visited in sorted-key order, the order in which the reference flattens
its trees, so a leaf's path names the same parameter in both packages
(`decoder.g0.L5.ssd.wz`).

Every parameter and activation is annotated with *logical* axis names; a
`ShardingRules` table maps them to mesh axes, and `logical_to_mesh_axes`
/ `param_sharding` give the reference's `PartitionSpec` for a shape, as a
tuple with one entry per dim: None (replicated), an axis name, or a tuple
of names (sharded over their product, flattened in that order).  A mesh
is anything with named axis sizes: a `DeviceMesh` with
``mesh_dim_names``, or a mapping ``{"data": 2, "model": 4}``.

The reference leaves the partitioning to GSPMD.  The port computes SPMD
on local shards, explicitly: each rank holds the local shard of each
leaf that its spec names (`local_shard`), each block computes on its
local heads, columns or experts, and the reference's `shard_act`
becomes a relayout between two layouts that the rules name
(`act_spec`; `parallel.collectives.relayout`: an all-gather where a dim
turns replicated, a slice where it turns sharded, an all-to-all where a
mesh axis moves between dims, nothing where the layouts agree;
`models.layers.block_input` / `to_residual` for the residual stream).
`sharding_ctx` installs the mesh and rules for the blocks, with the
global sizes that a local shard cannot tell them (the batch, the
sequence, the cache length).
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.swarm_arrays import resolve_device


@dataclass(frozen=True)
class ParamSpec:
    """Declarative parameter: shape + logical axes + init recipe."""
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    dtype: Any = torch.float32
    init: str = "normal"          # normal | zeros | ones | embed
    scale: float = 1.0            # multiplier on fan-in init
    # the dim (index) eligible for extra FSDP sharding; -1 = auto, -2 =
    # opted out
    fsdp_dim: int = -1

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} and logical axes "
                             f"{self.logical} differ in rank")


Logical = Tuple[Optional[str], ...]
# one entry per dim: None, a mesh axis name, or a tuple of names
Spec = Tuple[Any, ...]


@dataclass(frozen=True)
class ShardingRules:
    rules: Dict[str, Tuple[str, ...]]
    fsdp_axes: Tuple[str, ...] = ()

    def mesh_axes(self, logical: Optional[str]) -> Tuple[str, ...]:
        if logical is None:
            return ()
        return tuple(self.rules.get(logical, ()))


# Training: pure DP over pods x data, ZeRO-3 over data, sequence-parallel
# residual stream, tensor / expert parallelism over model.
DEFAULT_RULES = ShardingRules(
    rules={
        "batch": ("pod", "data"),
        "seq_act": ("model",),
        "kv_seq": (),
        "heads": ("model",),
        "kv_heads": ("model",),
        "mlp": ("model",),
        "experts": ("model",),
        "vocab": ("model",),
        "embed": (),
        "ssm_heads": ("model",),
        "ssm_inner": ("model",),
    },
    fsdp_axes=("data",),
)

# Inference: params TP-only (replicated over data), batch over (pod, data),
# long KV caches sequence-sharded over ("data", "model").
INFERENCE_RULES = ShardingRules(
    rules={
        "batch": ("pod", "data"),
        "seq_act": (),
        "kv_seq": ("data", "model"),
        "heads": ("model",),
        "kv_heads": ("model",),
        "mlp": ("model",),
        "experts": ("model",),
        "vocab": ("model",),
        "embed": (),
        "ssm_heads": ("model",),
        "ssm_inner": ("model",),
    },
    fsdp_axes=(),
)


def infer_rules(cfg=None) -> ShardingRules:
    """Inference rules for a config: a MoE model adds FSDP over ``data``
    to its TP weights (gathered a layer at a time)."""
    if cfg is not None and getattr(cfg, "num_experts", 0):
        return ShardingRules(rules=dict(INFERENCE_RULES.rules),
                             fsdp_axes=("data",))
    return INFERENCE_RULES


# --------------------------------------------------------------------------- #
def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a `DeviceMesh`, a mapping, or a mesh with a
    name -> size ``shape`` mapping (jax's)."""
    if mesh is None:
        return {}
    if isinstance(mesh, dict):
        return {str(k): int(v) for k, v in mesh.items()}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: int(s) for n, s in zip(names, mesh.shape)}
    return {str(k): int(v) for k, v in dict(mesh.shape).items()}


def entry_axes(entry) -> Tuple[str, ...]:
    """A spec entry (None, a name or a tuple of names) as a tuple."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def _entry(axes: Sequence[str]):
    axes = tuple(axes)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def _axis_size(mesh, axes: Sequence[str]) -> int:
    sizes = axis_sizes(mesh)
    return int(math.prod(sizes[a] for a in axes)) if axes else 1


def _present(mesh, axes: Sequence[str]) -> Tuple[str, ...]:
    sizes = axis_sizes(mesh)
    return tuple(a for a in axes if a in sizes)


def _fit_axes(mesh, dim: int, axes: Sequence[str]) -> Tuple[str, ...]:
    """Keep the longest prefix of `axes` whose size product divides `dim`."""
    axes = _present(mesh, axes)
    while axes and dim % _axis_size(mesh, axes) != 0:
        axes = axes[:-1]
    return axes


def logical_to_mesh_axes(mesh, shape: Sequence[int], logical: Logical,
                         rules: ShardingRules) -> Spec:
    """The spec of an array of ``shape`` with ``logical`` axes: each dim
    takes its rule's axes not used by an earlier dim, cut to the longest
    prefix that divides it."""
    used: set = set()
    out = []
    for dim, name in zip(shape, logical):
        axes = tuple(a for a in rules.mesh_axes(name) if a not in used)
        axes = _fit_axes(mesh, dim, axes)
        used.update(axes)
        out.append(_entry(axes))
    return tuple(out)


def param_sharding(mesh, spec: ParamSpec, rules: ShardingRules) -> Spec:
    """TP sharding from logical axes + optional extra FSDP sharding: the
    rules' ``fsdp_axes`` go to ``spec.fsdp_dim`` when it is free and
    divisible, else to the largest free dim they divide; a param that
    opted out (-2), or that already uses an FSDP axis, takes none."""
    pspec = list(logical_to_mesh_axes(mesh, spec.shape, spec.logical, rules))
    fsdp = _present(mesh, rules.fsdp_axes)
    if spec.fsdp_dim == -2:   # param opted out of FSDP
        fsdp = ()
    used = {a for entry in pspec for a in entry_axes(entry)}
    if any(a in used for a in fsdp):
        fsdp = ()             # an fsdp axis is already consumed by this param
    if fsdp:
        fsdp_size = _axis_size(mesh, fsdp)
        cand = None
        if spec.fsdp_dim >= 0 and pspec[spec.fsdp_dim] is None \
                and spec.shape[spec.fsdp_dim] % fsdp_size == 0:
            cand = spec.fsdp_dim
        else:
            dims = sorted(range(len(spec.shape)), key=lambda i: -spec.shape[i])
            for i in dims:
                if pspec[i] is None and spec.shape[i] % fsdp_size == 0:
                    cand = i
                    break
        if cand is not None:
            pspec[cand] = _entry(fsdp)
    return tuple(pspec)


def specs_to_shardings(tree, mesh, rules: ShardingRules):
    """The `param_sharding` spec of every leaf of a spec tree."""
    return tree_map_specs(lambda s: param_sharding(mesh, s, rules), tree)


def specs_to_abstract(tree, mesh=None, rules: ShardingRules = DEFAULT_RULES,
                      dtype_override=None):
    """Meta tensors of every leaf: the global shape without a mesh, this
    rank's local shard's shape under ``param_sharding`` with one."""
    def mk(s: ParamSpec):
        shape = s.shape if mesh is None else local_shape(
            s.shape, param_sharding(mesh, s, rules), mesh)
        return torch.empty(shape, dtype=dtype_override or s.dtype,
                           device="meta")
    return tree_map_specs(mk, tree)


# --------------------------------------------------------------------------- #
# Local shards
# --------------------------------------------------------------------------- #
def mesh_coords(mesh) -> Dict[str, int]:
    """This rank's coordinate on each axis of a `DeviceMesh`."""
    names = mesh.mesh_dim_names
    return dict(zip(names, mesh.get_coordinate()))


def shard_index(mesh, axes: Sequence[str]) -> int:
    """This rank's index along ``axes`` flattened in their order (the
    first axis major), as the reference flattens a multi-axis dim."""
    if not axes:
        return 0
    sizes, coords = axis_sizes(mesh), mesh_coords(mesh)
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + coords[a]
    return idx


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    return tuple(d // _axis_size(mesh, entry_axes(e))
                 for d, e in zip(shape, spec))


def local_shard(x, spec: Spec, mesh):
    """This rank's block of a global tensor or array ``x`` under
    ``spec`` (a view where ``x`` is a tensor)."""
    out = x
    for dim, e in enumerate(spec):
        axes = entry_axes(e)
        if not axes:
            continue
        n = _axis_size(mesh, axes)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over {axes} ({n})")
        size = x.shape[dim] // n
        start = shard_index(mesh, axes) * size
        index = [slice(None)] * len(spec)
        index[dim] = slice(start, start + size)
        out = out[tuple(index)]
    return out


# --------------------------------------------------------------------------- #
# Activation layouts
# --------------------------------------------------------------------------- #
_CURRENT: dict = {"mesh": None, "rules": DEFAULT_RULES, "dims": {}}


class sharding_ctx:
    """Context manager installing (mesh, rules) for the blocks, and the
    global sizes (``batch``, ``seq``, ``cache_len``) that their local
    shards do not show."""

    def __init__(self, mesh, rules: ShardingRules, **dims: int):
        self.new = {"mesh": mesh, "rules": rules, "dims": dims}

    def __enter__(self):
        self.old = dict(_CURRENT)
        _CURRENT.update(self.new)
        return self

    def __exit__(self, *exc):
        _CURRENT.update(self.old)
        return False


def current_mesh():
    return _CURRENT["mesh"]


def current_rules() -> ShardingRules:
    return _CURRENT["rules"]


def current_dim(name: str, default: Optional[int] = None) -> int:
    """A global size installed by `sharding_ctx` (``batch``, ``seq``,
    ``cache_len``); ``default`` outside a mesh, where local sizes are
    global."""
    if _CURRENT["mesh"] is None and default is not None:
        return default
    dims = _CURRENT["dims"]
    if name not in dims:
        raise ValueError(f"sharding_ctx holds no global {name!r}")
    return dims[name]


def with_dims(**dims: int):
    """`sharding_ctx` of the current mesh and rules with ``dims`` over
    the installed global sizes (the encoder's own sequence); a null
    context outside a mesh."""
    if _CURRENT["mesh"] is None:
        return contextlib.nullcontext()
    return sharding_ctx(_CURRENT["mesh"], _CURRENT["rules"],
                        **{**_CURRENT["dims"], **dims})


def act_spec(shape: Sequence[int], *logical: Optional[str]) -> Spec:
    """The layout the rules give an activation of global ``shape``: all
    None outside a mesh."""
    mesh = current_mesh()
    if mesh is None:
        return (None,) * len(shape)
    return logical_to_mesh_axes(mesh, shape, logical, current_rules())


# --------------------------------------------------------------------------- #
# Spec-tree utilities
# --------------------------------------------------------------------------- #
def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map_specs(fn: Callable[[ParamSpec], Any], tree):
    """Apply ``fn`` to every `ParamSpec` leaf of a nested dict."""
    if is_spec(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map_specs(fn, v) for k, v in tree.items()}
    raise TypeError(f"not a spec tree node: {type(tree).__name__}")


def tree_leaves_with_path(tree, prefix: str = "", sep: str = "."
                          ) -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs of a nested dict, in sorted-key order, the keys
    joined by ``sep``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves_with_path(
                tree[k], f"{prefix}{sep}{k}" if prefix else str(k), sep)
    else:
        yield prefix, tree


def _std(s: ParamSpec) -> float:
    """The reference's fan-in rule (`repro.parallel.sharding.init_param`):
    fan-in is ``shape[0]``, or ``shape[-2]`` for rank >= 3 (stacked)."""
    if s.init == "embed":
        return s.scale
    fan_in = s.shape[0] if len(s.shape) >= 2 else max(s.shape[-1], 1)
    if len(s.shape) >= 3:
        fan_in = s.shape[-2]
    return s.scale / math.sqrt(max(fan_in, 1))


# f32 elements drawn at a time (1 GiB): a larger leaf is filled in slices
# along its leading axis
DRAW_ELEMENTS = 1 << 28


def init_param(gen: torch.Generator, s: ParamSpec, dtype=None,
               device="cuda") -> torch.Tensor:
    """One leaf in ``dtype`` (the spec's by default).  The normal draw is
    taken in f32 and cast, slice by slice along the leading axis, at most
    `DRAW_ELEMENTS` elements a slice, so the f32 temporary stays at about
    1 GiB; a smaller leaf is one slice (a stacked expert leaf of
    qwen3-moe-30b-a3b, 9.66e9 elements, would need 38.7 GB in one draw)."""
    dev = resolve_device(device)
    dt = dtype or s.dtype
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=dt, device=dev)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=dt, device=dev)
    std = _std(s)
    out = torch.empty(s.shape, dtype=dt, device=dev)
    rows = max(1, DRAW_ELEMENTS // max(1, math.prod(s.shape[1:])))
    for r0 in range(0, s.shape[0], rows):
        part = out[r0:r0 + rows]
        w = torch.randn(part.shape, generator=gen, dtype=torch.float32,
                        device=dev)
        part.copy_(w.mul_(std))
    return out


def init_params(seed: int, tree, dtype=None, device="cuda"):
    """Nested dicts of tensors for a spec tree, drawn from one
    ``torch.Generator`` on ``device`` seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    out: dict = {}
    for path, s in tree_leaves_with_path(tree):
        _set_path(out, path, init_param(gen, s, dtype, dev))
    return out


def init_params_numpy(seed: int, tree, dtype=np.float32):
    """Nested dicts of numpy arrays for a spec tree, drawn from
    ``numpy.random.default_rng(seed)`` by the same rule.  Both packages can
    be handed these arrays, which is how the tests and the card's check
    against the reference share weights."""
    rng = np.random.default_rng(int(seed))
    out: dict = {}
    for path, s in tree_leaves_with_path(tree):
        if s.init == "zeros":
            a = np.zeros(s.shape, dtype)
        elif s.init == "ones":
            a = np.ones(s.shape, dtype)
        else:
            a = rng.standard_normal(s.shape, dtype=np.float32)
            a *= np.float32(_std(s))
            a = a.astype(dtype, copy=False)
        _set_path(out, path, a)
    return out


def _set_path(tree: dict, path: str, value) -> None:
    *heads, last = path.split(".")
    node = tree
    for h in heads:
        node = node.setdefault(h, {})
    node[last] = value
