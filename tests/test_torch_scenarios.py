"""The batched flash-crowd loop of `repro_torch` against the reference:
Scenarios VII and IX run in one process in both packages (reference numpy
backend, port on the CPU) and must give identical events, virtual-time
metrics and per-node egress; and the committed expected values in
`src/repro_torch/reference_runs.json` must still be what both packages
produce under PYTHONHASHSEED=0.

The protocol iterates sets of node-name strings, so its trace follows the
process's string hash seed: the two packages agree bit for bit inside one
process, or across processes with PYTHONHASHSEED fixed.

Regenerate the expected values with
    PYTHONHASHSEED=0 PYTHONPATH=src:. python tests/test_torch_scenarios.py \
        --write-reference-runs
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
RUNS_FILE = ROOT / "src" / "repro_torch" / "reference_runs.json"
METRICS = ("events", "makespan_s", "full_replication_s", "p99_completion_s",
           "cross_isp_bytes", "origin_up_mb", "replicas")
# entry -> (scenario, parameters); the first two are the chip sizes that
# chip_smoke.py runs on the card, the last two the small sizes that the
# tier-1 test below reruns on the CPU
RUNS = {
    "vii_n2000": ("scenario_vii", {"n_volunteers": 2000, "batched": True}),
    "ix_n500_i8": ("scenario_ix", {"n_volunteers": 500, "n_islands": 8}),
    "vii_n64": ("scenario_vii", {"n_volunteers": 64, "batched": True}),
    "ix_n64_i4": ("scenario_ix", {"n_volunteers": 64, "n_islands": 4}),
}
SMALL = ("vii_n64", "ix_n64_i4")


def summarize(scenario, res):
    if scenario == "scenario_vii":
        return {k: res[k] for k in METRICS}
    return {arm: {k: res[arm][k] for k in METRICS} for arm in ("naive", "p4p")}


def run_entry(package, name):
    """One entry of RUNS in the reference (numpy backend) or the port
    (device="cpu"), summarized to METRICS."""
    scenario, params = RUNS[name]
    if package == "reference":
        from benchmarks import paper_tables as mod
        kw = {"backend": "numpy"}
    else:
        from repro_torch import scenarios as mod
        kw = {"device": "cpu"}
    res = getattr(mod, scenario)(verbose=False, **params, **kw)
    return summarize(scenario, res)


def _recording_runtime(monkeypatch, module):
    """Replace `module.SimRuntime` with a subclass that records every
    instance, so a test can read each run's per-node `tx_bytes`."""
    seen = []
    base = module.SimRuntime

    class Recording(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen.append(self)

    monkeypatch.setattr(module, "SimRuntime", Recording)
    return seen


def _both(monkeypatch, scenario, **params):
    from benchmarks import paper_tables as ref
    from repro_torch import scenarios as port
    ref_rts = _recording_runtime(monkeypatch, ref)
    port_rts = _recording_runtime(monkeypatch, port)
    a = getattr(ref, scenario)(verbose=False, backend="numpy", **params)
    b = getattr(port, scenario)(verbose=False, device="cpu", **params)
    assert len(ref_rts) == len(port_rts) > 0
    for ra, rb in zip(ref_rts, port_rts):
        assert ra.tx_bytes == rb.tx_bytes
        assert ra.events_processed == rb.events_processed
    return a, b


@pytest.mark.parametrize("n", [8, 64, 200])
def test_scenario_vii_batched_port_matches_reference(monkeypatch, n):
    a, b = _both(monkeypatch, "scenario_vii", n_volunteers=n, batched=True)
    assert summarize("scenario_vii", a) == summarize("scenario_vii", b)
    assert b["done"] and b["replicated"] and b["replicas"] == n
    assert b["device"] == "cpu"
    assert b["batch_ops"] == a["batch_ops"]
    assert b["ledger_ops"] == a["ledger_ops"]
    assert b["coalesced_events"] == a["coalesced_events"]


def test_scenario_ix_port_matches_reference_both_arms(monkeypatch):
    a, b = _both(monkeypatch, "scenario_ix", n_volunteers=64, n_islands=4)
    assert summarize("scenario_ix", a) == summarize("scenario_ix", b)
    assert b["done"] and b["replicated"]
    assert b["p4p"]["device"] == "cpu"
    # the P4P arm really moved traffic onto the islands
    assert b["p4p"]["cross_isp_bytes"] < b["naive"]["cross_isp_bytes"]


_GOLDEN_SCRIPT = """
import json, sys
sys.path[:0] = ["src", "."]
from tests.test_torch_scenarios import SMALL, run_entry
print(json.dumps({pkg: {name: run_entry(pkg, name) for name in SMALL}
                  for pkg in ("reference", "port")}))
"""


def test_reference_runs_file_matches_both_packages():
    """Rerun the small entries of reference_runs.json under
    PYTHONHASHSEED=0 in the reference and in the port (CPU): both must
    equal the committed values, so the file cannot go stale unnoticed."""
    golden = json.loads(RUNS_FILE.read_text())
    assert golden["pythonhashseed"] == "0"
    assert set(golden["runs"]) == set(RUNS)
    for name, (scenario, params) in RUNS.items():
        assert golden["runs"][name]["scenario"] == scenario
        assert golden["runs"][name]["params"] == params
    env = dict(os.environ, PYTHONHASHSEED="0", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(["src", "."]))
    out = subprocess.run([sys.executable, "-c", _GOLDEN_SCRIPT], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    for pkg in ("reference", "port"):
        for name in SMALL:
            assert got[pkg][name] == golden["runs"][name]["result"], \
                (pkg, name)


def write_reference_runs():
    if os.environ.get("PYTHONHASHSEED") != "0":
        env = dict(os.environ, PYTHONHASHSEED="0")
        os.execve(sys.executable, [sys.executable, *sys.argv], env)
    import numpy as np
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                            capture_output=True, text=True).stdout.strip()
    runs = {}
    for name, (scenario, params) in RUNS.items():
        runs[name] = {"scenario": scenario, "params": params,
                      "result": run_entry("reference", name)}
        print(name, json.dumps(runs[name]["result"]), flush=True)
    RUNS_FILE.write_text(json.dumps({
        "what": "virtual-time results of the reference package src/repro "
                "(numpy swarm backend) for the batched flash-crowd "
                "scenarios; the port must reproduce them exactly",
        "pythonhashseed": "0",
        "reference_commit": commit or None,
        "numpy": np.__version__,
        "generated_by": "PYTHONHASHSEED=0 PYTHONPATH=src:. python "
                        "tests/test_torch_scenarios.py "
                        "--write-reference-runs",
        "runs": runs,
    }, indent=1) + "\n")


if __name__ == "__main__":
    if "--write-reference-runs" in sys.argv[1:]:
        sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
        write_reference_runs()
    else:
        sys.exit("usage: python tests/test_torch_scenarios.py "
                 "--write-reference-runs")
