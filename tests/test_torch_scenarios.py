"""The swarm scenarios of `repro_torch` against the reference: Scenarios
VII, VIII (batched), IX and X run in one process in both packages
(reference numpy backend, port on the CPU) and must give identical
events, virtual-time metrics and per-node egress; and the committed
expected values in `src/repro_torch/reference_runs.json` must still be
what both packages produce under PYTHONHASHSEED=0.

The reference's `scenario_viii` has no `batched` argument: its batched
runs here are that same function with the reference `ChaosScenario` in
its own batched mode (`batched=True, backend="numpy"`), as the port's
`scenario_viii(batched=True)` runs the port's.

The protocol iterates sets of node-name strings, so its trace follows the
process's string hash seed: the two packages agree bit for bit inside one
process, or across processes with PYTHONHASHSEED fixed.

Regenerate the expected values with
    PYTHONHASHSEED=0 PYTHONPATH=src:. python tests/test_torch_scenarios.py \
        --write-reference-runs
"""
import contextlib
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.scenarios import virtual_time_fields  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RUNS_FILE = ROOT / "src" / "repro_torch" / "reference_runs.json"
# entry -> (scenario, parameters); "chaos" is one ChaosScenario run and
# its report.  The chip sizes (CHIP) are the runs chip_smoke.py makes on
# the card; SMALL are the sizes that the tier-1 test below reruns on the
# CPU
RUNS = {
    "vii_n2000": ("scenario_vii", {"n_volunteers": 2000, "batched": True}),
    "ix_n500_i8": ("scenario_ix", {"n_volunteers": 500, "n_islands": 8}),
    "vii_n64": ("scenario_vii", {"n_volunteers": 64, "batched": True}),
    "ix_n64_i4": ("scenario_ix", {"n_volunteers": 64, "n_islands": 4}),
    "viii_n200_batched": ("scenario_viii",
                          {"n_volunteers": 200, "batched": True}),
    "chaos_n200_i8_batched": ("chaos", {
        "seed": 8, "n_volunteers": 200, "n_pieces": 32, "n_parts": 400,
        "m_min": 1, "image_bytes": 32_000_000, "real_image": False,
        "loss": 0.10, "dup": 0.02, "jitter_s": 0.2, "churn": 0.30,
        "n_partitions": 1, "horizon_s": 120.0, "partition_s": 20.0,
        "until_s": 4 * 3600.0, "batched": True, "n_islands": 8,
        "island_partitions": True}),
    "x_n200": ("scenario_x", {}),
    "viii_n24_batched": ("scenario_viii",
                         {"n_volunteers": 24, "batched": True}),
    "x_n24_p80": ("scenario_x", {
        "n_volunteers": 24, "image_mb": 8.0, "n_pieces": 80,
        "chaos_volunteers": 12, "chaos_pieces": 16,
        "chaos_image_mb": 1.0}),
    # the scalar runs: the paper's tables and Scenarios V, VI and XI at
    # their defaults (chip_smoke.py's paper_tables_phase), and XI cut to
    # R=8 / 256 MB for the CPU tests
    "table1": ("table1", {}),
    "table2": ("table2", {}),
    "table3": ("table3", {}),
    "table4": ("table4", {}),
    "scenario_v": ("scenario_v", {}),
    "scenario_vi": ("scenario_vi", {}),
    "xi_r50": ("scenario_xi", {}),
    "xi_r8_256mb": ("scenario_xi", {"n_replicas": 8, "ckpt_mb": 256.0,
                                    "n_pieces": 32, "n_islands": 4}),
}
SMALL = ("vii_n64", "ix_n64_i4", "viii_n24_batched", "x_n24_p80")


@contextlib.contextmanager
def _reference_chaos_batched():
    """The reference `scenario_viii` with its `ChaosScenario` in batched
    mode on the numpy backend (the function imports the class per call)."""
    import repro.core.chaos as rc
    cls = rc.ChaosScenario
    rc.ChaosScenario = functools.partial(cls, batched=True, backend="numpy")
    try:
        yield
    finally:
        rc.ChaosScenario = cls


@contextlib.contextmanager
def _recorded(module, name):
    """Wrap `module.name`, a function, so that every result it returns is
    appended to the list this yields."""
    fn = getattr(module, name)
    seen = []

    def recording(*a, **kw):
        seen.append(fn(*a, **kw))
        return seen[-1]

    setattr(module, name, recording)
    try:
        yield seen
    finally:
        setattr(module, name, fn)


def run_scalar(package, scenario, params):
    """One of the paper's tables or Scenarios V, VI, XI in either package
    (no device is involved).  A reference table's result gains its run's
    `ScenarioOut` under "scenario_out", as the port's tables carry it."""
    from repro_torch import scenarios as port
    if package == "port":
        return getattr(port, scenario)(verbose=False, **params)
    from benchmarks import paper_tables as ref
    if scenario not in port.TABLES:
        return getattr(ref, scenario)(verbose=False, **params)
    with _recorded(ref, "run_scenario") as outs:
        res = getattr(ref, scenario)(verbose=False, **params)
    (out,) = outs
    return dict(res, scenario_out=port.scenario_out_fields(out))


def run_scenario(package, scenario, params):
    """Run one scenario in the reference (numpy backend) or the port
    (device="cpu"); returns its full result ("chaos": the report of a
    run whose invariants were checked)."""
    from repro_torch.scenarios import SCALAR
    if scenario in SCALAR:
        return run_scalar(package, scenario, params)
    params = dict(params)
    if scenario == "chaos":
        if package == "reference":
            from repro.core.chaos import ChaosScenario
            kw = {"backend": "numpy"}
        else:
            from repro_torch.core.chaos import ChaosScenario
            kw = {"device": "cpu"}
        sc = ChaosScenario(**params, **kw).run()
        sc.check_invariants()
        return sc.report()
    if package == "port":
        from repro_torch import scenarios as mod
        return getattr(mod, scenario)(verbose=False, device="cpu", **params)
    from benchmarks import paper_tables as mod
    if scenario == "scenario_viii":
        if params.pop("batched", False):
            with _reference_chaos_batched():
                return mod.scenario_viii(verbose=False, **params)
        return mod.scenario_viii(verbose=False, **params)
    return getattr(mod, scenario)(verbose=False, backend="numpy", **params)


def run_entry(package, name):
    """One entry of RUNS in the reference or the port, summarized to its
    virtual-time fields."""
    scenario, params = RUNS[name]
    return virtual_time_fields(scenario,
                               run_scenario(package, scenario, params))


def _recording_runtime(monkeypatch, *modules):
    """Replace each module's `SimRuntime` with a subclass that records
    every instance in one list, so a test can read each run's per-node
    `tx_bytes`."""
    seen = []
    for module in modules:
        class Recording(module.SimRuntime):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                seen.append(self)

        monkeypatch.setattr(module, "SimRuntime", Recording)
    return seen


def _both(monkeypatch, scenario, **params):
    """Run `scenario` in both packages in this process; every run's
    per-node egress and event count must agree."""
    import repro.core.chaos as ref_chaos
    import repro_torch.core.chaos as port_chaos
    from benchmarks import paper_tables as ref
    from repro_torch import scenarios as port
    ref_rts = _recording_runtime(monkeypatch, ref, ref_chaos)
    port_rts = _recording_runtime(monkeypatch, port, port_chaos)
    a = run_scenario("reference", scenario, params)
    b = run_scenario("port", scenario, params)
    assert len(ref_rts) == len(port_rts) > 0
    for ra, rb in zip(ref_rts, port_rts):
        assert ra.tx_bytes == rb.tx_bytes
        assert ra.events_processed == rb.events_processed
    return a, b


@pytest.mark.parametrize("n", [8, 64, 200])
def test_scenario_vii_batched_port_matches_reference(monkeypatch, n):
    a, b = _both(monkeypatch, "scenario_vii", n_volunteers=n, batched=True)
    assert virtual_time_fields("scenario_vii", a) \
        == virtual_time_fields("scenario_vii", b)
    assert b["done"] and b["replicated"] and b["replicas"] == n
    assert b["device"] == "cpu"
    assert b["batch_ops"] == a["batch_ops"]
    assert b["ledger_ops"] == a["ledger_ops"]
    assert b["coalesced_events"] == a["coalesced_events"]


def test_scenario_ix_port_matches_reference_both_arms(monkeypatch):
    a, b = _both(monkeypatch, "scenario_ix", n_volunteers=64, n_islands=4)
    assert virtual_time_fields("scenario_ix", a) \
        == virtual_time_fields("scenario_ix", b)
    assert b["done"] and b["replicated"]
    assert b["p4p"]["device"] == "cpu"
    # the P4P arm really moved traffic onto the islands
    assert b["p4p"]["cross_isp_bytes"] < b["naive"]["cross_isp_bytes"]


def test_scenario_viii_batched_port_matches_reference(monkeypatch):
    """Both chaos arms on the batched path: crashes, restarts, loss and a
    partition give the same trace in both packages, and both arms pass
    the invariants (with the port's device-plane check)."""
    a, b = _both(monkeypatch, "scenario_viii", n_volunteers=24,
                 batched=True)
    assert virtual_time_fields("scenario_viii", a) \
        == virtual_time_fields("scenario_viii", b)
    assert b["replicated"] and b["invariants_ok"] and b["device"] == "cpu"
    c = b["chaos"]
    assert c["restarts"] == c["crashes"] > 0 and c["dropped_msgs"] > 0
    for arm in ("baseline", "chaos"):
        for k in ("batch_ops", "ledger_ops", "coalesced_events"):
            assert b[arm][k] == a[arm][k] > 0, (arm, k)
        assert b[arm]["kernel_wall_s"] <= b[arm]["tick_wall_s"]


def test_scenario_x_port_matches_reference_above_64_pieces(monkeypatch):
    """v1 crowd, v2 delta and scratch re-fetch at 80 pieces (the orders'
    sort route and the matcher's wide route on the card), and the scalar
    chaos overlay with real bytes: identical in both packages."""
    a, b = _both(monkeypatch, "scenario_x", **RUNS["x_n24_p80"][1])
    assert virtual_time_fields("scenario_x", a) \
        == virtual_time_fields("scenario_x", b)
    assert b["upgraded"] and b["replicated"] and b["chaos_ready"]
    assert b["stale_accepts"] == 0 and b["no_stale"]
    assert b["reused_pieces"] > 0
    assert b["device"] == "cpu" and b["batch_ops"] > 0


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
    """Take every entry of RUNS that the file lacks (or holds with other
    parameters) from the reference; entries already there are kept.
    Delete the file to take them all again."""
    if os.environ.get("PYTHONHASHSEED") != "0":
        env = dict(os.environ, PYTHONHASHSEED="0")
        os.execve(sys.executable, [sys.executable, *sys.argv], env)
    import numpy as np
    old = json.loads(RUNS_FILE.read_text()) if RUNS_FILE.exists() else {}
    commit = old.get("reference_commit") or subprocess.run(
        ["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
        text=True).stdout.strip()
    runs = {}
    for name, (scenario, params) in RUNS.items():
        kept = old.get("runs", {}).get(name)
        if kept and kept["scenario"] == scenario \
                and kept["params"] == params:
            runs[name] = kept
            continue
        runs[name] = {"scenario": scenario, "params": params,
                      "result": run_entry("reference", name)}
        print(name, json.dumps(runs[name]["result"]), flush=True)
    RUNS_FILE.write_text(json.dumps({
        "what": "virtual-time results of the reference package src/repro "
                "(numpy swarm backend) for the swarm scenarios; the port "
                "must reproduce them exactly",
        "pythonhashseed": "0",
        "reference_commit": commit or None,
        "numpy": old.get("numpy", np.__version__),
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
