"""One run of one cell of the benchmark of the PyTorch port.

Everything that belongs to a cell is found by name: the cell's entry in
``BENCHMARK.json`` names its configuration (``configs/<name>.json``),
whose ``reference`` names the benchmark's model of its architecture
(``reference/<name>.py``: `reference_module`), and its traffic mix
(``traffic/<name>.json``), whose ``kind`` names the loop that drives and
judges it (``loops/<kind>.py``: `load_loop`); its
per-layer metrics are the manifest's ``per_layer`` entries that list the
cell or its end-to-end metric, each read by ``metrics/<name>.py``; the
limits of its comparison are ``limits/<cell>.json``.  Adding a cell, a
configuration, a mix, a kind of traffic or a metric adds files and
entries and edits none.

A run: set-up (imports, the card, the kernel library, weights drawn on
the card from the seed, a pool of distinct batches, warm-up calls of the
cell's one shape), then the measured window of ``seconds``, closed loop,
one call in flight; with ``trace`` a few more calls under the profiler,
spans hooked around the program's functions that the metrics read; then
the comparison of the timed path's outputs with the reference."""
from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import statistics
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from portbench import check
from portbench import tracing as tr

BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # top-level module names


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_entry(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                   f"{[w['name'] for w in man['workloads']]}")


def config_file(man: dict, name: str, bench: Path = BENCH) -> dict:
    for c in man["configs"]:
        if c["name"] == name:
            return load_json(bench.parent / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def cell_metrics(man: dict, cell: str, trace: bool) -> List[dict]:
    """The manifest's metrics that this cell reports: its end-to-end
    metrics without ``trace``, its per-layer metrics with it."""
    e2e = [m for m in man["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names
                             else [])]


def load_file(path: Path, prefix: str):
    """The module of the Python file ``path``, loaded once a process."""
    key = str(path.resolve())
    if key not in _LOADED:
        name = f"{prefix}_{path.stem.replace('.', '_').replace('-', '_')}"
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[key] = mod
    return _LOADED[key]


_LOADED: Dict[str, Any] = {}


def load_metric(name: str, bench: Path = BENCH):
    """The reader of a per-layer metric, ``metrics/<name>.py``: a module
    with ``read(run) -> float | None`` and, optionally, ``SPANS``, the
    (module, function, tag) triples to hook while tracing."""
    return load_file(bench / "metrics" / f"{name}.py", "portbench_metric")


def reference_module(config: str, conf: dict, bench: Path = BENCH):
    """The plain reference of the configuration ``config`` (its file's
    dict ``conf``): the module ``reference/<conf["reference"]>.py``, whose
    contract is in `reference/ops.py`.  A configuration that names none is
    refused."""
    if "reference" not in conf:
        raise ValueError(f"configuration {config!r} names no reference "
                         "module: its file needs a top-level \"reference\", "
                         "the name of a module in portbench/reference/")
    return load_file(bench / "reference" / f"{conf['reference']}.py",
                     "portbench_reference")


def load_loop(kind: str, bench: Path = BENCH):
    """The loop of a kind of traffic, ``loops/<kind>.py``: a module with
    ``run(ctx) -> numbers`` (set-up, which ends with
    ``ctx.setup_done()``; the window, which sets ``ctx.e2e``,
    ``ctx.attempted``, ``ctx.failed`` and ``ctx.step_s`` and calls
    ``ctx.window_closed``; with ``ctx.trace`` ``ctx.profile``; then the
    comparison's numbers of the timed path), ``readings(ctx, who) ->
    numbers`` (the same numbers of the program, ``who`` "program", or of
    the control, with no window: `calibrate.py`) and ``FAULTS``, {name:
    a context manager that breaks the timed path underneath}."""
    return load_file(bench / "loops" / f"{kind}.py", "portbench_loop")


def forbidden_modules(names=None) -> List[str]:
    """The module names (those loaded in this process by default) whose
    top-level name is one of FORBIDDEN, compared whole (``repro_torch``
    is not ``repro``)."""
    return sorted({n for n in (sys.modules if names is None else names)
                   if n.split(".", 1)[0] in FORBIDDEN})


def program_config(conf: dict, device: str):
    """The port's registered configuration with every size of the
    configuration file's ``run_as`` applied (the benchmark pins what it
    runs), its layer groups, its dtype, and the hand-written kernels on
    the card."""
    from repro_torch.configs.base import GroupSpec, LayerSpec, get_config
    m = conf["run_as"]
    groups = tuple(GroupSpec(tuple(LayerSpec(**ls) for ls in g["layers"]),
                             g["repeat"]) for g in m["groups"])
    sizes = {k: v for k, v in m.items() if k not in ("registered", "groups")}
    cfg = get_config(m["registered"]).replace(groups=groups, **sizes)
    return cfg.replace(use_pallas=device == "cuda")


def cell_config(conf: dict, traffic: dict, device: str):
    """`program_config`, with what the traffic sets of the step (remat)."""
    cfg = program_config(conf, device)
    return cfg.replace(remat=traffic["remat"]) if "remat" in traffic else cfg


def quantile(xs: List[float], q: float) -> float:
    """The ``q`` quantile of xs, linear between order statistics."""
    return statistics.quantiles(xs, n=100, method="inclusive")[
        round(q * 100) - 1] if len(xs) > 1 else xs[0]


@dataclass
class Run:
    """What a run hands its per-layer metric readers."""
    conf: dict                 # the configuration file
    ref: Any                   # its reference module (`reference_module`)
    traffic: dict              # the traffic file
    step_s: float              # unprofiled seconds a call in the window
    steps_traced: int
    trace: Optional[tr.Trace] = None

    @property
    def m(self) -> dict:
        return self.conf["run_as"]

    def per_step(self, ops) -> float:
        return sum(op.dur_s for op in ops) / self.steps_traced


def sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def free_memory(device: str) -> None:
    import gc
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()


def model_launches() -> Dict[str, int]:
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssd import kernel as sk
    return {**fk.LAUNCHES, **sk.LAUNCHES}


# ------------------------------------------------------------------ a run
class Context:
    """The state of one run, shared by its loop and the harness."""

    def __init__(self, cell: str, seed: int, seconds: float, trace: bool,
                 device: str, t_start: float, root: Path, bench: Path):
        self.cell, self.seed, self.seconds = cell, int(seed), seconds
        self.trace, self.device, self.t_start = trace, device, t_start
        self.t_made = time.time()
        self.man = manifest(root)
        self.entry = cell_entry(self.man, cell)
        self.conf = config_file(self.man, self.entry["config"], bench)
        self.ref = reference_module(self.entry["config"], self.conf, bench)
        self.traffic = load_json(bench / "traffic" /
                                 f"{self.entry['traffic']}.json")
        self.limits = load_json(bench / "limits" / f"{cell}.json")
        self.metrics = cell_metrics(self.man, cell, trace)
        self.readers = ({m["name"]: load_metric(m["name"], bench)
                         for m in self.metrics} if trace else {})
        self.loop = load_loop(self.traffic["kind"], bench)
        self.cfg = cell_config(self.conf, self.traffic, device)
        self.setup_s = None
        self.attempted = self.failed = 0
        self.e2e: Dict[str, float] = {}
        self.step_s = math.nan
        self.traced: Optional[tr.Trace] = None
        self.peak_bytes = 0

    @property
    def m(self) -> dict:
        return self.conf["run_as"]

    def note(self, msg: str) -> None:
        print(f"[portbench] {msg}", file=sys.stderr, flush=True)

    def setup_done(self) -> None:
        self.setup_s = time.time() - self.t_start
        self.note(f"set-up {self.setup_s:.3f} s (the harness started at "
                  f"{self.t_made - self.t_start:.3f} s)")

    def window_closed(self, after: Dict[str, int], before: Dict[str, int],
                      calls: int) -> None:
        if self.device == "cuda":
            self.peak_bytes = torch.cuda.max_memory_allocated()
        launches = {k: (after[k] - before[k]) // calls for k in after}
        self.note(f"kernel launches a call {json.dumps(launches)}")

    def spans(self):
        """Every span that this run's metric readers ask for, hooked."""
        stack = contextlib.ExitStack()
        for reader in self.readers.values():
            for mod, fn, tag in getattr(reader, "SPANS", ()):
                stack.enter_context(tr.hooked(importlib.import_module(mod),
                                              fn, tag=tag))
        return stack

    def profile(self, call) -> None:
        n = self.traffic["profile_steps"]
        for i in range(n):                    # untimed, spans on
            call(i)
        self.traced = tr.profile(lambda: [call(i) for i in range(n)])
        tied = sum(op.dur_s for op in self.traced.launched)
        self.note(f"device seconds tied to a launching CPU op {tied:.6f} of "
                  f"{sum(op.dur_s for op in self.traced.ops):.6f}")


def run(cell: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", t_start: Optional[float] = None,
        root: Optional[Path] = None, bench: Path = BENCH) -> dict:
    """One run of ``cell``: the result line's dict (`result`)."""
    root = root or bench.parent
    ctx = Context(cell, seed, seconds, trace, device,
                  t_start if t_start is not None else time.time(), root,
                  bench)
    return result(ctx, ctx.loop.run(ctx))


def result(ctx: Context, numbers: Dict[str, float]) -> dict:
    checks = {k: {"value": numbers.get(k, math.nan), "limit": v}
              for k, v in ctx.limits.items()}
    for k in numbers:
        if k not in checks:
            checks[k] = {"value": numbers[k], "limit": None}
    correct = check.verdict(numbers, ctx.limits) and ctx.failed == 0
    metrics = {}
    if ctx.trace:
        run = Run(ctx.conf, ctx.ref, ctx.traffic, ctx.step_s,
                  ctx.traffic["profile_steps"], ctx.traced)
        for m in ctx.metrics:
            v = ctx.readers[m["name"]].read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = dict(ctx.e2e, setup_s=ctx.setup_s)
        for m in ctx.metrics:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    device = {"platform": "gpu" if ctx.device == "cuda" else ctx.device,
              "kind": (torch.cuda.get_device_name(0) if ctx.device == "cuda"
                       else "cpu"),
              "count": 1, "memory_peak_bytes": ctx.peak_bytes}
    out = {"correct": bool(correct), "attempted": ctx.attempted,
           "failed": ctx.failed, "metrics": metrics, "device": device}
    if ctx.trace and ctx.traced is not None:
        device["busy_s"] = ctx.traced.busy_s
        device["window_s"] = ctx.traced.window_s
        out["breakdown"] = {"device_ops": ctx.traced.device_ops(10),
                            "idle_gaps": ctx.traced.idle_gaps}
    out["checks"] = checks
    return out
