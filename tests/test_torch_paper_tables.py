"""The source paper's Tables I-IV (Scenarios I-IV: 2,000,000 to 3,000,000
integers on up to six volunteers) in `repro_torch.scenarios` against the
reference's `benchmarks/paper_tables.py`.

Table I runs in one process in both packages: the per-node egress, the
event count, every virtual-time field and the printed line must be
equal.  Tables II-IV run in the port in a subprocess under
PYTHONHASHSEED=0 (the protocol's trace follows the string hash seed) and
must equal their `src/repro_torch/reference_runs.json` entries, which
were taken from the reference under that seed.  Every table runs at its
own size.
"""
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from repro_torch import scenarios as port  # noqa: E402
from test_torch_scenarios import (ROOT, RUNS, RUNS_FILE,  # noqa: E402
                                  _recorded, _recording_runtime)


def test_table1_port_matches_reference_in_one_process(monkeypatch, capsys):
    from benchmarks import paper_tables as ref
    ref_rts = _recording_runtime(monkeypatch, ref)
    port_rts = _recording_runtime(monkeypatch, port)
    with _recorded(ref, "run_scenario") as outs:
        a = ref.table1()
    ref_line = capsys.readouterr().out
    b = port.table1()
    assert capsys.readouterr().out == ref_line
    assert ref_line.startswith("[table1] parallel=1.82h")
    a = dict(a, scenario_out=port.scenario_out_fields(outs[0]))
    assert len(ref_rts) == len(port_rts) == 1
    assert ref_rts[0].tx_bytes == port_rts[0].tx_bytes
    assert ref_rts[0].events_processed == port_rts[0].events_processed > 0
    assert port.virtual_time_fields("table1", a) \
        == port.virtual_time_fields("table1", b)
    # the calibration anchor: Scenario I's 1.82 h on three VMs, ~6.35 s a
    # cycle, ~1030 cycles per volunteer
    assert sum(b["cycles"].values()) == port.APP1["parts"]
    assert all(abs(v - 6.35) < 0.01 for v in b["avg_s"].values())
    json.dumps(port.virtual_time_fields("table1", b))


_SCRIPT = """
import json, sys
sys.path[:0] = ["src", "tests"]
from test_torch_scenarios import run_entry
print(json.dumps(run_entry("port", sys.argv[1])))
"""


@pytest.mark.parametrize("table", ["table2", "table3", "table4"])
def test_table_matches_reference_runs_file(table):
    """The port's table under PYTHONHASHSEED=0 equals the reference's
    committed values field for field, the ScenarioOut's per-node cycles,
    seconds a cycle and leeched MB among them."""
    golden = json.loads(RUNS_FILE.read_text())["runs"][table]
    assert golden["scenario"] == RUNS[table][0] == table
    env = dict(os.environ, PYTHONHASHSEED="0",
               PYTHONPATH=os.pathsep.join(["src", "."]))
    out = subprocess.run([sys.executable, "-c", _SCRIPT, table], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == golden["result"]
    so = got["scenario_out"]
    assert set(so["makespan_h"]) == {"app1", "app2"}
    assert so["cycles"] and set(so["cycles"]) == set(so["data_mb"])
    # every part of both applications was computed at least once
    for app, spec in (("app1", port.APP1), ("app2", port.APP2)):
        assert sum(v for k, v in so["cycles"].items()
                   if k.startswith(app + "/")) >= spec["parts"]
