"""Scenarios V (piece-wise swarm against a single seeder, and origin
failover), VI (choking and endgame cancels) and XI (a flash crowd of
serving replicas cold-starting from a checkpoint: origin-only against
swarm, flat and on ISP islands, and the origin's death) in
`repro_torch.scenarios` against the reference.

Each runs in one process in both packages: every run's per-node egress
and event count, every virtual-time field and the printed lines must be
equal.  XI runs at R=8, 256 MB, 32 pieces, 4 islands here (the default
R=50 / 2 GB run takes about a minute a package; `chip_smoke.py` runs
it).  Then V, VI and that XI run in the port under PYTHONHASHSEED=0 in
a subprocess must equal their `src/repro_torch/reference_runs.json`
entries.
"""
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from repro_torch import scenarios as port  # noqa: E402
from test_torch_scenarios import (ROOT, RUNS, RUNS_FILE,  # noqa: E402
                                  _recording_runtime)


def _both(monkeypatch, capsys, entry):
    """Run the reference and the port in this process; returns both
    results after holding every run's egress and events and the printed
    lines equal."""
    from benchmarks import paper_tables as ref
    scenario, params = RUNS[entry]
    ref_rts = _recording_runtime(monkeypatch, ref)
    port_rts = _recording_runtime(monkeypatch, port)
    a = getattr(ref, scenario)(**params)
    ref_lines = capsys.readouterr().out
    b = getattr(port, scenario)(**params)
    assert capsys.readouterr().out == ref_lines
    assert ref_lines.count(f"[scenario{scenario.split('_')[1].upper()}]") \
        >= 1
    assert len(ref_rts) == len(port_rts) > 0
    for ra, rb in zip(ref_rts, port_rts):
        assert ra.tx_bytes == rb.tx_bytes
        assert ra.events_processed == rb.events_processed > 0
        assert ra.cross_isp_bytes == rb.cross_isp_bytes
    assert port.virtual_time_fields(scenario, a) \
        == port.virtual_time_fields(scenario, b)
    return a, b


def test_scenario_v_port_matches_reference(monkeypatch, capsys):
    _, b = _both(monkeypatch, capsys, "scenario_v")
    assert b["single"]["done"] and b["swarm"]["done"]
    assert b["failover"]["done"]
    # the swarm moves the image once in pieces: far less origin egress
    assert b["origin_bytes_reduction"] > 5


def test_scenario_vi_port_matches_reference(monkeypatch, capsys):
    _, b = _both(monkeypatch, capsys, "scenario_vi")
    assert all(b[arm]["done"] for arm in ("baseline", "unchoked", "choked"))
    assert b["baseline"]["cancelled_parts"] == 0
    assert b["dup_exec_reduction"] > 0


def test_scenario_xi_port_matches_reference(monkeypatch, capsys):
    _, b = _both(monkeypatch, capsys, "xi_r8_256mb")
    assert b["all_ready"] and b["chaos"]["ready"]
    assert b["egress_reduction_flat"] > 1
    assert b["islands"]["swarm"]["cross_isp_bytes"] > 0


def test_entry_point_prints_the_reference_lines(capsys):
    """`python -m repro_torch.scenarios scenario_v` prints the reference's
    line (one process, so one hash seed)."""
    from benchmarks import paper_tables as ref
    ref.scenario_v()
    want = capsys.readouterr().out
    port.main(["scenario_v"])
    assert capsys.readouterr().out == want
    with pytest.raises(SystemExit):
        port.main(["table9"])
    assert list(port.ALL_TABLES) == list(ref.ALL_TABLES)


_SCRIPT = """
import json, sys
sys.path[:0] = ["src", "tests"]
from test_torch_scenarios import run_entry
print(json.dumps({n: run_entry("port", n) for n in sys.argv[1:]}))
"""


def test_reference_runs_entries_match_the_port():
    names = ("scenario_v", "scenario_vi", "xi_r8_256mb")
    golden = json.loads(RUNS_FILE.read_text())["runs"]
    env = dict(os.environ, PYTHONHASHSEED="0",
               PYTHONPATH=os.pathsep.join(["src", "."]))
    out = subprocess.run([sys.executable, "-c", _SCRIPT, *names], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    for name in names:
        assert got[name] == golden[name]["result"], name
