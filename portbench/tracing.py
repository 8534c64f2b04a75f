"""Spans from outside the program, and the reading of a profiler trace.

`hooked` (as in the repository's `chip_smoke.py`) wraps a function of a
module of the program in a ``record_function`` span for the duration of
a traced window (the program has no span of its own at these boundaries
yet).  `profile` (after `chip_smoke.py`'s `profile_ranges`) runs a
callable under ``torch.profiler`` (CPU and CUDA) and reduces the trace
to what the per-layer metrics read: every device operation with its
time, each again with the names of the CPU ranges around the op that
launched it, the device's busy seconds, and the longest idle gaps by
what the host was doing."""
from __future__ import annotations

import contextlib
import inspect
import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple


@contextlib.contextmanager
def hooked(module, name: str, after=None, tag: str | None = None):
    """``module.name`` wrapped for the block: run under a profiler range
    ``tag``, and ``after(arguments, result)`` called on each call, with
    the call's arguments by the names of the function's signature (those
    passed: no defaults)."""
    import torch
    inner = getattr(module, name)
    sig = inspect.signature(inner) if after is not None else None

    def call(*args, **kw):
        if tag is None:
            out = inner(*args, **kw)
        else:
            with torch.profiler.record_function(tag):
                out = inner(*args, **kw)
        if after is not None:
            after(sig.bind(*args, **kw).arguments, out)
        return out
    setattr(module, name, call)
    try:
        yield
    finally:
        setattr(module, name, inner)


@contextlib.contextmanager
def patched(module, name: str, value):
    """``module.name`` replaced by ``value`` for the block: how a fault
    is planted underneath the timed path."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


@dataclass
class DeviceOp:
    name: str
    start_s: float
    dur_s: float
    ancestors: Tuple[str, ...]   # CPU ranges around its launch, innermost first

    @property
    def is_kernel(self) -> bool:
        return not self.name.startswith(("Memcpy", "Memset"))


@dataclass
class Trace:
    ops: List[DeviceOp]
    window_s: float                  # host clock around the traced calls
    busy_s: float                    # union of the device operations' time
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)
    # the device operations again, each with the CPU ranges around the op
    # that launched it (no start times)
    launched: List[DeviceOp] = field(default_factory=list)

    def device_ops(self, n: int = 10, width: int = 100
                   ) -> List[Tuple[str, float]]:
        """The ``n`` device operations that took most time, summed by the
        first ``width`` letters of their names."""
        sums: Dict[str, float] = {}
        for op in self.ops:
            key = op.name[:width]
            sums[key] = sums.get(key, 0.0) + op.dur_s
        return sorted(sums.items(), key=lambda kv: -kv[1])[:n]

    def under(self, tag: str) -> List[DeviceOp]:
        """The device operations launched inside a CPU range named
        ``tag`` (an autograd node's or a span's name ends with it)."""
        return [op for op in self.launched
                if any(a.endswith(tag) for a in op.ancestors)]


def profile(fn: Callable[[], None]) -> Trace:
    """``fn()`` under the profiler, synchronised; its device operations
    (kernels, copies, sets) with their launching CPU ranges."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    card = torch.cuda.is_available()
    sync = torch.cuda.synchronize if card else (lambda: None)
    sync()
    with torch_profile(activities=[ProfilerActivity.CPU] +
                       [ProfilerActivity.CUDA] * card) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        window = time.perf_counter() - t0
    events = prof.events()
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    device = [e for e in events if e.device_type != DeviceType.CPU
              and not getattr(e, "is_user_annotation", False)]
    ops = [DeviceOp(e.name, e.time_range.start / 1e6,
                    e.time_range.elapsed_us() / 1e6, ()) for e in device]
    launched = tied(cpu)
    ops.sort(key=lambda o: o.start_s)
    busy, end, gaps = 0.0, None, []
    for op in ops:
        stop = op.start_s + op.dur_s
        if end is None or op.start_s >= end:
            if end is not None:
                gaps.append((op.start_s - end, end))
            busy += op.dur_s
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    return Trace(ops, window, busy, _name_gaps(gaps, cpu), launched)


def tied(cpu) -> List[DeviceOp]:
    """Each device operation once, with the CPU ranges around the op that
    launched it, innermost first.  The profiler lists a kernel among the
    kernels of every CPU event that carries its launch's correlation id
    (the launching op, a "Command Buffer Full" wait, a library's nested
    launches): of the events that share an id, the innermost one's list
    is taken."""
    def chain(e):
        out = []
        while e is not None:
            out.append(e.name)
            e = e.cpu_parent
        return tuple(out)
    owner: Dict[int, Tuple[Tuple[str, ...], list]] = {}
    for e in cpu:
        if e.kernels:
            c = chain(e)
            if len(c) > len(owner.get(e.id, ((), []))[0]):
                owner[e.id] = (c, e.kernels)
    return [DeviceOp(k.name, math.nan, k.duration / 1e6, c)
            for c, kernels in owner.values() for k in kernels]


def _name_gaps(gaps, cpu, n: int = 10) -> List[Tuple[str, float]]:
    """The longest idle gaps, summed by the innermost CPU range that was
    running when each began: what the host was doing meanwhile."""
    named: Dict[str, float] = {}
    for dur, at in sorted(gaps, reverse=True)[:30]:
        us = at * 1e6
        best, depth = "host (no range)", -1
        for evt in cpu:
            if evt.time_range.start <= us < evt.time_range.end:
                d, e = 0, evt.cpu_parent
                while e is not None:
                    d, e = d + 1, e.cpu_parent
                if d > depth:
                    best, depth = evt.name, d
        named[best] = named.get(best, 0.0) + dur
    return sorted(named.items(), key=lambda kv: -kv[1])[:n]
