"""Cost analysis of one step as it runs, op by op, on meta tensors.

Counterpart of `repro.launch.hlo_analysis` (``analyze_hlo``).  The
reference parses the compiled per-device HLO; the port has no HLO, so
`analyze_step` runs one rank's step (usually on meta tensors under a
fake process group, `launch.dryrun`) and counts what it dispatches:

  * ``dot_flops``: `torch.utils.flop_counter.FlopCounterMode`'s count
    (matmuls, einsums, convolutions, and the two kernels through the
    FLOP formulas their custom ops register, `kernels.*.kernel`);
  * ``flops``: those plus one FLOP an output element of each pointwise
    op and one an input element of each reduction, as the reference
    counts its elementwise and reduce instructions;
  * ``bytes_accessed``: each op's tensor inputs and outputs, once each,
    views and metadata ops excepted.  Nothing is fused here, so this is
    an upper bound on the traffic of a fused program (the reference's
    HLO is fused);
  * ``collective_bytes``, ``collectives`` (operand bytes by kind) and
    ``coll_ops``: each collective that `parallel.collectives` issued
    (kind, operand and output bytes, group size, the mesh axes it spans,
    count), as `collectives.recording` logs it;
  * ``peak_bytes``: the high-water mark of live tensor storage (each
    storage counted once while any tensor of it lives; the arguments
    count from the start), through weak references on the storages;
  * ``stats``: the change of `collectives.STATS` over the step (calls by
    kind and wire bytes, as a measured run counts them).

`collective_link_bytes` carries over the reference's ring weighting.
"""
from __future__ import annotations

import collections
import weakref
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

# the kernels' custom ops register their FLOP formulas on import, and a
# FlopCounterMode reads the registry when it is made
from repro_torch.kernels.flash_attention import kernel as _flash  # noqa: F401
from repro_torch.kernels.ssd import kernel as _ssd  # noqa: F401
from repro_torch.parallel import collectives

_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod", "var",
               "std", "logsumexp", "cumsum", "norm", "linalg_vector_norm",
               "_softmax", "_log_softmax", "all", "any", "argmax", "argmin"}
# ops that only describe or alias their inputs: no traffic
_FREE = {"detach", "alias", "lift_fresh", "_local_scalar_dense", "empty",
         "empty_like", "empty_strided", "new_empty", "new_empty_strided",
         "set_", "resize_", "_has_compatible_shallow_copy_type"}


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Live:
    """Bytes of the tensor storages alive, and their high-water mark."""

    def __init__(self):
        self.bytes = 0
        self.peak = 0
        self._refs = WeakIdKeyDictionary()

    def add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._refs:
            return
        n = st.nbytes()
        self.bytes += n
        self.peak = max(self.peak, self.bytes)
        self._refs[st] = weakref.ref(st, lambda _, n=n: self._drop(n))

    def _drop(self, n: int) -> None:
        self.bytes -= n


class _OpCounter(TorchDispatchMode):
    def __init__(self, live: _Live):
        super().__init__()
        self.live = live
        self.elementwise = 0.0
        self.bytes = 0.0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        outs = _tensors(out)
        for t in outs:
            self.live.add(t)
        if name in _FREE or getattr(func, "is_view", False):
            return out
        self.ops += 1
        ins = {id(t): t for t in _tensors((args, kwargs))}
        self.bytes += sum(_nbytes(t) for t in ins.values())
        self.bytes += sum(_nbytes(t) for t in outs)
        if torch.Tag.pointwise in func.tags:
            self.elementwise += sum(t.numel() for t in outs)
        elif name in _REDUCTIONS:
            self.elementwise += sum(t.numel() for t in ins.values())
        return out


def _aggregate(ops: List[dict]) -> List[dict]:
    agg: Dict[tuple, dict] = {}
    for op in ops:
        key = (op["kind"], op["operand_bytes"], op["out_bytes"], op["group"],
               tuple(op["axes"]))
        e = agg.setdefault(key, dict(op, count=0.0))
        e["count"] += 1.0
    return sorted(agg.values(), key=lambda e: -e["operand_bytes"]
                  * e["count"])


def analyze_step(fn, *args, n_devices: int = 1) -> dict:
    """Run ``fn(*args)`` once, counting what it dispatches and the
    collectives it issues; the per-rank analysis, with the reference's
    keys plus ``peak_bytes``, ``stats``, ``output_bytes`` and
    ``n_ops``."""
    live = _Live()
    for t in _tensors(args):
        live.add(t)
    before = collections.Counter(collectives.STATS)
    counter = _OpCounter(live)
    with collectives.recording() as ops, \
            FlopCounterMode(display=False) as flops, counter:
        out = fn(*args)
    stats = collections.Counter(collectives.STATS)
    stats.subtract(before)
    coll: Dict[str, float] = collections.defaultdict(float)
    for op in ops:
        coll[op["kind"]] += op["operand_bytes"]
    dot = float(flops.get_total_flops())
    return {
        "flops": dot + counter.elementwise,
        "dot_flops": dot,
        "bytes_accessed": counter.bytes,
        "collective_bytes": float(sum(coll.values())),
        "collectives": dict(coll),
        "coll_ops": _aggregate(ops),
        "n_devices": n_devices,
        "peak_bytes": live.peak,
        "output_bytes": sum(_nbytes(t) for t in _tensors(out)),
        "stats": {k: v for k, v in stats.items()
                  if k != "seconds" and v},
        "n_ops": counter.ops,
    }


def collective_link_bytes(coll_ops: List[dict]) -> float:
    """Effective serialized bytes per device at link bandwidth, assuming
    ring algorithms: all-reduce 2(R-1)/R x operand; all-gather (R-1)/R x
    output; reduce-scatter / all-to-all (R-1)/R x operand; permute 1x."""
    total = 0.0
    for op in coll_ops:
        r = max(op.get("group", 0), 1)
        f = (r - 1) / r if r > 1 else 0.0
        kind = op["kind"]
        n = op.get("count", 1.0)
        if kind == "all-reduce":
            b = 2.0 * f * op["operand_bytes"]
        elif kind == "all-gather":
            b = f * max(op["out_bytes"], op["operand_bytes"])
        elif kind in ("reduce-scatter", "all-to-all", "ragged-all-to-all"):
            b = f * op["operand_bytes"]
        else:  # collective-broadcast, collective-permute
            b = op["operand_bytes"]
        total += b * n
    return total
