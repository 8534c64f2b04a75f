"""The per-layer metrics that read the program's own spans and MoE slot
counter, at a reduced size on the CPU: a traced small run of the prefill
cell reports the host-clock and counter readings (`step_host_ms.prefill`,
`moe_slot_fill.prefill`) and the device-ms readers give None (the CPU's
trace has no device operation); the train cell's traced run records the
program's spans and reports none of them; `program`'s reductions are
checked on records made by hand; and every new reader gives None, and does
not raise, against a program that has no such span or counter."""
import json
import sys
from types import SimpleNamespace

import pytest
import torch

from portbench_small import CELLS, ROOT, run_small, small_tree, one_thread  # noqa: F401
from portbench import harness, program
from repro_torch import spans

DEVICE_MS = ["attention_ms.prefill", "moe_route_ms.prefill",
             "moe_dispatch_ms.prefill", "moe_experts_ms.prefill",
             "moe_combine_ms.prefill"]
PROGRAM = ["step_host_ms.prefill", "moe_slot_fill.prefill"]


@pytest.fixture(autouse=True)
def empty_totals():
    """The program's totals hold every profiled call of the process: each
    test starts and ends with them empty."""
    spans.clear()
    yield
    spans.clear()


@pytest.mark.parametrize("config", sorted(CELLS))
def test_a_traced_small_run_reads_the_program_spans(tmp_path, config):
    tree = small_tree(tmp_path, config)
    out = run_small(tree, CELLS[config], trace=True)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    assert not set(DEVICE_MS) & set(got)
    if config.endswith(".stage4"):
        # the one profiled step ran under the program's spans; no metric
        # of the train cell reads them
        assert spans.COUNTS["train.step"] == 1
        assert spans.RECORDS["moe.slots"]
        assert not set(PROGRAM) & set(got)
        return
    host, fill = PROGRAM
    assert spans.COUNTS["serve.prefill"] == 1
    assert got[host]["unit"] == "ms" and got[host]["value"] > 0
    # a small batch is dropless (at most 512 tokens): every assignment
    # kept, N k of E N slots filled
    m = json.loads((tree / "portbench" / "configs" /
                    f"{config}.json").read_text())["run_as"]
    assert got[fill] == {"value": 100.0 * m["experts_per_token"]
                         / m["num_experts"], "unit": "%"}


@pytest.mark.parametrize("counts, cap, fill", [
    ([[3, 1, 0, 4]], 4, 50.0),                  # nothing dropped
    ([[7, 1, 0, 0], [2, 2, 2, 2]], 2, 68.75),   # 5 of the first dropped
])
def test_slot_fill_reduces_every_recorded_plan(counts, cap, fill):
    spans.RECORDS["moe.slots"].extend(
        (torch.tensor(c), cap) for c in counts)
    assert program.slot_fill() == fill


def test_span_host_ms_is_seconds_over_count():
    spans.SECONDS["serve.prefill"] += 0.9
    spans.COUNTS["serve.prefill"] += 3
    assert program.span_host_ms("serve.prefill") == pytest.approx(300.0)
    assert program.span_host_ms("train.step") is None


# a run whose trace tied no device operation to a CPU range
NO_TRACE = SimpleNamespace(steps_traced=1,
                           trace=SimpleNamespace(under=lambda tag: []))


@pytest.mark.parametrize("name", DEVICE_MS + PROGRAM)
def test_a_program_without_the_spans_reads_none(name, monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert harness.load_metric(name).read(NO_TRACE) is None


def test_every_new_metric_lists_its_cell_and_layer():
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    per_layer = {m["name"]: m for m in man["per_layer"]}
    layers = {m["layer"] for m in per_layer.values()}
    for name in DEVICE_MS + PROGRAM:
        assert per_layer[name]["workloads"] == [CELLS["qwen3-moe-30b-a3b"]]
        assert per_layer[name]["moves"] == "prefill_tokens_per_s"
    assert per_layer["moe_route_ms.prefill"]["layer"] == \
        per_layer["moe_block_ms.prefill"]["layer"]
    assert "attention (models/attention.attention_block)" in layers
