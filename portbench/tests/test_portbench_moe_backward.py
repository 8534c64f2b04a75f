"""The per-layer metric `moe_backward_ms.train`, which reads the ops under
the program's ``moe.backward`` spans, at a reduced size on the CPU: a traced
small run of the train cell, its CPU ops standing in for kernels, reports a
positive reading; the reader gives None, and does not raise, against a
program that has no such span; and its manifest entry names its cell, layer
and end-to-end metric."""
import json
import math
import sys
from types import SimpleNamespace

import pytest

from portbench_small import CELLS, ROOT, run_small, small_tree, one_thread  # noqa: F401
from portbench import harness, tracing
from repro_torch import spans

NAME = "moe_backward_ms.train"
CONFIG = "qwen3-moe-30b-a3b.stage4"


@pytest.fixture(autouse=True)
def empty_totals():
    """The program's totals hold every profiled call of the process: each
    test starts and ends with them empty."""
    spans.clear()
    yield
    spans.clear()


def cpu_tied(cpu):
    """Each CPU op with no CPU op inside it, standing in for the kernel it
    would launch on a card (the CPU's trace has none): its own CPU time,
    with the names of the ranges around it, innermost first."""
    def chain(e):
        out = []
        while e is not None:
            out.append(e.name)
            e = e.cpu_parent
        return tuple(out)
    return [tracing.DeviceOp(e.name, math.nan, e.self_cpu_time_total / 1e6,
                             chain(e))
            for e in cpu if not e.cpu_children]


def test_moe_backward_reads_a_cpu_trace_of_a_small_train_step(
        tmp_path, monkeypatch):
    """The traced run of the small train cell: the reader reads the ops
    under the program's ``moe.backward`` spans, two a MoE layer."""
    tree = small_tree(tmp_path, CONFIG)
    monkeypatch.setattr(tracing, "tied", cpu_tied)
    out = run_small(tree, CELLS[CONFIG], trace=True)
    assert out["correct"], out["checks"]
    got = out["metrics"][NAME]
    assert got["unit"] == "ms" and got["value"] > 0
    m = json.loads((tree / "portbench" / "configs" /
                    f"{CONFIG}.json").read_text())["run_as"]
    n_moe = sum(g["repeat"] * sum(ls["mlp"] == "moe" for ls in g["layers"])
                for g in m["groups"])
    # the one profiled step's backward (the untimed step before it runs
    # with no profiler)
    assert spans.COUNTS["moe.backward"] == 2 * n_moe


def test_a_program_without_the_span_reads_none(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    run = SimpleNamespace(steps_traced=1,
                          trace=SimpleNamespace(under=lambda tag: []))
    assert harness.load_metric(NAME).read(run) is None


def test_the_metric_lists_its_cell_and_layer():
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    per_layer = {m["name"]: m for m in man["per_layer"]}
    assert per_layer[NAME]["workloads"] == [CELLS[CONFIG]]
    assert per_layer[NAME]["moves"] == "train_tokens_per_s"
    assert per_layer[NAME]["layer"] == \
        per_layer["moe_block_ms.prefill"]["layer"]
