"""Named spans of the port's steps, recorded only while a profiler records.

`span(name)` is a ``torch.profiler.record_function`` range while a
``torch.profiler`` profile records (the profiler's own enabled flag,
read once a call), and one shared no-op context otherwise: a range
entered with no profiler on still dispatches two profiler ops (several µs
on a CPU), the flag costs a fraction of one.  While on, the spans are
CPU ranges of the same trace as the device's operations: one clock,
each span's parent the range around it, each kernel tied to the spans
around its launch.  Each span also adds its host seconds and one count
to `SECONDS` and `COUNTS`, and the program keeps what it counts while a
profiler records under a name in `RECORDS`; nothing is written out: a
reader takes them after the traced calls, and `clear()` empties all
three.

The port's spans: ``serve.prefill`` (one device's prefill step,
`training.train_state`), ``train.step``, ``train.backward`` (the main
thread's `torch.autograd.grad`; the backward's kernels launch from
autograd's device thread, under its nodes), ``adamw_update``,
``remat_forward`` / ``remat_recompute`` (`models.model`),
``attention_block`` (`models.attention`) and the four parts that tile
`models.moe.moe_block`: ``moe.route``, ``moe.dispatch``, ``moe.experts``
and ``moe.combine``; ``moe.backward``, the backwards of the block's two
reads through its slot map (`models.moe._Dispatch`, `_Combine`), entered
from autograd's thread, two a MoE layer and step; ``shared_block``
(`models.model.shared_block`, one a Zamba2 block application: its count
is the applications a call), ``ssd_block`` (`models.ssm.ssd_block`) and
``ssd.backward`` (`kernels.ssd.ops.SSDScan`'s backward, on autograd's
thread, one an SSD layer and step).  Records:
``moe.slots`` (`models.moe`)."""
from __future__ import annotations

import collections
import contextlib
import functools
import time

import torch
from torch.autograd import profiler as _profiler

# host seconds and entries of each span since the last `clear`
SECONDS: collections.Counter = collections.Counter()
COUNTS: collections.Counter = collections.Counter()
# what the program recorded under each name while a profiler recorded,
# since the last `clear`
RECORDS: collections.defaultdict = collections.defaultdict(list)

_OFF = contextlib.nullcontext()


def recording() -> bool:
    """Whether a ``torch.profiler`` profile records now."""
    return _profiler._is_profiler_enabled


class _Span:
    __slots__ = ("name", "range", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        self.range.__exit__(*exc)
        SECONDS[self.name] += dt
        COUNTS[self.name] += 1
        return False


def span(name: str):
    """A profiler range ``name`` with its host time counted while a
    profiler records; the shared no-op context otherwise."""
    return _Span(name) if _profiler._is_profiler_enabled else _OFF


def spanned(name: str):
    """Decorator: the function's body under `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            with span(name):
                return fn(*args, **kw)
        return call
    return wrap


def clear() -> None:
    SECONDS.clear()
    COUNTS.clear()
    RECORDS.clear()
