"""The harness at a reduced size on the CPU: the plumbing of a run and
its last line, discovery by name (a throwaway cell, mix, configuration,
metric and kind of traffic added as files to a copy, no file edited),
calibration through a cell's own loop, the manifest's rules, the check
for JAX's modules, and the refusal to run without a card."""
import hashlib
import json
import re
import subprocess
import sys

import pytest

from portbench_small import CELLS, ROOT, run_small, small_tree, one_thread  # noqa: F401
from portbench import calibrate, harness

PREFILL = CELLS["qwen3-moe-30b-a3b"]

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.fixture(scope="module")
def prefill_tree(tmp_path_factory):
    return small_tree(tmp_path_factory.mktemp("q"), "qwen3-moe-30b-a3b")


def test_a_run_prints_every_key(prefill_tree):
    cell = PREFILL
    out = run_small(prefill_tree, cell)
    assert KEYS <= set(out) and list(out)[-1] == "checks"
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    want = {m["name"] for m in harness.cell_metrics(man, cell, False)}
    assert set(out["metrics"]) == want and "setup_s" in want
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(out)                              # one JSON line


def test_a_traced_run_reads_its_per_layer_metrics(prefill_tree):
    cell = PREFILL
    out = run_small(prefill_tree, cell, trace=True)
    assert out["correct"], out["checks"]
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    listed = {m["name"] for m in harness.cell_metrics(man, cell, True)}
    # the CPU has no device trace: only what the host clock gives is read
    assert set(out["metrics"]) <= listed and "mfu.prefill" in out["metrics"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_cell_mix_config_and_metric_are_found_by_name(tmp_path):
    tree = small_tree(tmp_path, "qwen3-moe-30b-a3b")
    bench = tree / "portbench"
    before = digest(bench)
    # new files only: a configuration, a mix, a metric, a cell's limits
    conf = json.loads((bench / "configs" /
                       "qwen3-moe-30b-a3b.json").read_text())
    conf["run_as"]["groups"][0]["repeat"] = 1
    (bench / "configs" / "qwen3-throwaway.json").write_text(
        json.dumps(conf))
    mix = json.loads((bench / "traffic" / "prefill_8x2048.json").read_text())
    mix.update(batch=1, seq=48)
    (bench / "traffic" / "throwaway_mix.json").write_text(json.dumps(mix))
    (bench / "metrics" / "throwaway_metric.py").write_text(
        "def read(run):\n    return 42.0 + run.traffic['seq']\n")
    cell = "qwen3-throwaway.throwaway_mix"
    (bench / "limits" / f"{cell}.json").write_text(
        (bench / "limits" / f"{PREFILL}.json").read_text())
    # ... and entries in the manifest
    man = json.loads((tree / "BENCHMARK.json").read_text())
    man["configs"].append(dict(man["configs"][0], name="qwen3-throwaway",
                               file="portbench/configs/"
                                    "qwen3-throwaway.json"))
    man["workloads"].append({"name": cell, "config": "qwen3-throwaway",
                             "traffic": "throwaway_mix", "chips": 1,
                             "why": "throwaway"})
    man["per_layer"].append({"name": "throwaway_metric", "unit": "count",
                             "better": "higher", "source": "program_counter",
                             "layer": "device",
                             "moves": "prefill_tokens_per_s",
                             "workloads": [cell]})
    for m in man["end_to_end"]:
        if "workloads" in m and PREFILL in m["workloads"]:
            m["workloads"].append(cell)
    (tree / "BENCHMARK.json").write_text(json.dumps(man))
    after = digest(bench)
    assert all(after[p] == h for p, h in before.items())   # nothing edited
    out = run_small(tree, cell, trace=True)
    assert out["metrics"]["throwaway_metric"]["value"] == 90.0
    assert out["attempted"] % 1 == 0 and out["correct"], out["checks"]


# A kind of traffic of its own: its loop, found by the kind's name, drives
# a product on the device, reports an end-to-end metric of its own and is
# judged; calibration reads it through the same loop.
THROWAWAY_LOOP = """
import time
import torch
from portbench import harness as H


def step(n):
    a = torch.ones(n, n, device="cpu")
    return float((a @ a).sum())


def run(ctx):
    n = ctx.traffic["size"]
    ctx.setup_done()
    got, start = [], time.perf_counter()
    while time.perf_counter() - start < ctx.seconds or not got:
        got.append(step(n))
    elapsed = time.perf_counter() - start
    ctx.window_closed(H.model_launches(), H.model_launches(), len(got))
    ctx.attempted, ctx.step_s = len(got), elapsed / len(got)
    ctx.e2e = {"throwaway_products_per_s": len(got) / elapsed}
    if ctx.trace:
        ctx.profile(lambda i: step(n))
    return {"product_err": max(abs(g - n ** 3) for g in got)}


def readings(ctx, who):
    n = ctx.traffic["size"]
    return {"product_err": 0.0 if who == "program" else float(n)}


FAULTS = {}
"""


def test_a_new_kind_of_traffic_is_found_by_name(tmp_path):
    tree = small_tree(tmp_path, "qwen3-moe-30b-a3b")
    bench = tree / "portbench"
    before = digest(bench)
    (bench / "loops" / "throwaway_kind.py").write_text(THROWAWAY_LOOP)
    (bench / "traffic" / "throwaway_products.json").write_text(json.dumps(
        {"kind": "throwaway_kind", "size": 8, "profile_steps": 2}))
    cell = "qwen3-moe-30b-a3b.throwaway_products"
    (bench / "limits" / f"{cell}.json").write_text(
        json.dumps({"product_err": 0.5}))
    man = json.loads((tree / "BENCHMARK.json").read_text())
    man["workloads"].append({"name": cell, "config": "qwen3-moe-30b-a3b",
                             "traffic": "throwaway_products", "chips": 1,
                             "why": "throwaway"})
    man["end_to_end"].insert(0, {
        "name": "throwaway_products_per_s", "unit": "1/s",
        "better": "higher", "bound": 0.05, "source": "host_clock",
        "workloads": [cell]})
    man["per_layer"].append({"name": "mfu.throwaway", "unit": "%",
                             "better": "higher", "source": "device_trace",
                             "layer": "device",
                             "moves": "throwaway_products_per_s",
                             "workloads": [cell]})
    (bench / "metrics" / "mfu.throwaway.py").write_text(
        "def read(run):\n    return 100.0 * 2 * run.traffic['size'] ** 3 "
        "/ run.step_s / 1e15\n")
    (tree / "BENCHMARK.json").write_text(json.dumps(man))
    after = digest(bench)
    assert all(after[p] == h for p, h in before.items())   # nothing edited
    out = run_small(tree, cell)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"throwaway_products_per_s", "setup_s"}
    out = run_small(tree, cell, trace=True)
    assert out["correct"] and set(out["metrics"]) == {"mfu.throwaway"}
    kw = dict(device="cpu", root=tree, bench=bench)
    assert calibrate.readings(cell, 3, "program", **kw) == {
        "product_err": 0.0}
    assert calibrate.readings(cell, 3, "control", **kw) == {
        "product_err": 8.0}


@pytest.mark.parametrize("config", ["qwen3-moe-30b-a3b",
                                    "qwen3-moe-30b-a3b.stage4"])
def test_calibration_reads_what_a_run_checks(tmp_path, config):
    """`calibrate.readings` of the program, through the cell's own loop,
    gives the numbers that a run of the same seed checks."""
    tree = small_tree(tmp_path, config)
    seed = 2 ** 31 + 3
    out = run_small(tree, CELLS[config], seed=seed)
    got = calibrate.readings(CELLS[config], seed, "program", device="cpu",
                             root=tree, bench=tree / "portbench")
    want = {k: c["value"] for k, c in out["checks"].items()
            if k != "rerun_mismatch"}
    assert got == pytest.approx(want, rel=1e-6, abs=1e-12)


NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def test_the_manifest_keeps_its_rules():
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= man["run_seconds"] <= 51
    cells = {w["name"]: w for w in man["workloads"]}
    used = {w["config"] for w in cells.values()}
    assert used == {c["name"] for c in man["configs"]}
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in \
        e2e["setup_s"]
    for m in man["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for c in cells.values():
        assert c["chips"] == 1 and len(c["why"]) <= 200
        assert any(c["name"] in m.get("workloads", [c["name"]])
                   for m in man["end_to_end"] if m["name"] != "setup_s")
        assert any(c["name"] in m.get("workloads", ())
                   for m in man["per_layer"])
    for m in man["per_layer"]:
        for w in m["workloads"]:     # each cell reports what it moves
            assert w in e2e[m["moves"]].get("workloads", [w])
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in man[k]]
    assert len(names) == len(set(names))
    assert all(NAME.fullmatch(n) for n in names)


@pytest.mark.parametrize("cell", sorted(CELLS.values()))
def test_every_cell_finds_its_files(cell):
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = ROOT / "portbench"
    entry = harness.cell_entry(man, cell)
    conf = next(c for c in man["configs"] if c["name"] == entry["config"])
    assert (ROOT / conf["file"]).is_file()
    traffic = json.loads((bench / "traffic" /
                          f"{entry['traffic']}.json").read_text())
    loop = harness.load_loop(traffic["kind"])
    assert callable(loop.run) and callable(loop.readings) and loop.FAULTS
    limits = json.loads((bench / "limits" / f"{cell}.json").read_text())
    assert limits and all(v is None or v >= 0 for v in limits.values())
    for m in harness.cell_metrics(man, cell, True):
        assert callable(harness.load_metric(m["name"]).read)


def test_forbidden_modules_compare_whole_top_level_names():
    fine = ["repro_torch", "repro_torch.models", "reproduce", "jaxx",
            "flaxen", "torch"]
    assert harness.forbidden_modules(fine) == []
    assert harness.forbidden_modules(fine + ["repro.core", "jax.numpy",
                                             "jaxlib", "flax", "repro"]) == \
        ["flax", "jax.numpy", "jaxlib", "repro", "repro.core"]


def test_a_run_loads_no_jax_nor_the_jax_package(tmp_path):
    tree = small_tree(tmp_path, "qwen3-moe-30b-a3b")
    code = (f"import sys; sys.path[:0] = [{str(ROOT / 'src')!r}, "
            f"{str(ROOT)!r}]\n"
            "from pathlib import Path\n"
            "from portbench import harness\n"
            f"t = Path({str(tree)!r})\n"
            f"out = harness.run({CELLS['qwen3-moe-30b-a3b']!r}, 7, 0.3, "
            "False, device='cpu', root=t, bench=t / 'portbench')\n"
            "print(out['correct'], harness.forbidden_modules())\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.stdout.strip().splitlines()[-1] == "True []", res.stderr[-3000:]


def test_the_command_refuses_to_run_without_a_card():
    res = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"),
                          "--workload", PREFILL, "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert res.returncode == 2 and res.stdout == "", res.stderr
    assert "CUDA" in res.stderr


def test_the_command_fails_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's own
    files the command exits non-zero and prints no result."""
    import shutil
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          PREFILL, "--seed", "1", "--seconds",
                          "1", "--trace", "0"], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert res.returncode != 0 and res.stdout == ""


def test_each_device_operation_is_tied_once():
    """The profiler lists a kernel under every CPU event that carries its
    launch's correlation id; a "Command Buffer Full" wait with the op's
    id must not count it again, and the innermost event's ranges are the
    kernel's."""
    from types import SimpleNamespace as NS
    from portbench import tracing

    def cpu(name, id, parent=None, kernels=()):
        return NS(name=name, id=id, cpu_parent=parent,
                  kernels=[NS(name=k, duration=us) for k, us in kernels])
    span = cpu("portbench.moe_block", 1)
    bmm = cpu("aten::bmm", 2, span, [("nvjet_gemm", 600.0)])
    wait = cpu("Command Buffer Full", 2, None, [("nvjet_gemm", 600.0)])
    add = cpu("aten::add", 3, None, [("elementwise_add", 300.0)])
    launched = tracing.tied([span, wait, bmm, add])
    assert sorted((op.name, op.ancestors) for op in launched) == [
        ("elementwise_add", ("aten::add",)),
        ("nvjet_gemm", ("aten::bmm", "portbench.moe_block"))]
    trace = tracing.Trace([], 1.0, 0.0, [], launched)
    assert sum(op.dur_s for op in trace.under("portbench.moe_block")) == \
        pytest.approx(6e-4)
