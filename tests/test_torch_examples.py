"""The port's examples (`examples/port_*.py`), each the counterpart of the
reference example of the same name, run with ``--device cpu`` at their
smallest size in a subprocess with a time limit of its own, their printed
lines checked: every part of the prime search validated, the engine's
published (d, p) per prompt bucket equal to the reference example's, the
loss falling, the restored state identical.  Without ``--device`` they
run on the card, so on a machine without one they raise."""
import importlib.util
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"


def run(script, *args, tmp_path, limit=120.0):
    # one thread: the examples' tiny ops gain nothing from more, and the
    # test workers share the cores
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               TMPDIR=str(tmp_path), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(EXAMPLES / script), *args],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=limit)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def buckets(text):
    """{bucket: (d, p)} from the published-units lines."""
    return {int(b): (float(d), int(p)) for b, d, p in re.findall(
        r"bucket<=\s*(\d+): d=\s*([\d.]+)B p=\s*(\d+)", text)}


def test_volunteer_cloud_validates_every_part(tmp_path):
    out = run("port_volunteer_cloud.py", tmp_path=tmp_path)
    assert "done: 6056 primes <= 60000 found" in out
    assert re.search(r"published units: d=[\d.]+MB p=24 ", out)
    cycles = [int(c) for c in re.findall(r"cycles=(\d+)", out)]
    assert len(cycles) == 3 and sum(cycles) >= 24


def test_serve_publishes_the_reference_examples_units(tmp_path):
    got = run("port_serve_lm.py", "--device", "cpu", tmp_path=tmp_path)
    assert re.search(r"qwen3-14b \(reduced\): 12 reqs, 96 tokens", got)
    want = run("serve_lm.py", tmp_path=tmp_path)
    assert buckets(got) and buckets(got) == buckets(want)


def test_train_loss_falls(tmp_path):
    out = run("port_train_lm.py", "--size", "tiny", "--steps", "30",
              "--batch", "2", "--seq", "32", "--device", "cpu",
              tmp_path=tmp_path)
    first, last = map(float, re.search(
        r"loss: first5=([\d.]+) last5=([\d.]+)", out).groups())
    assert last < first
    assert re.search(r"checkpoints at .*: \[.*30\]", out)
    assert "SDC sentinel reports: 0" in out


def test_elastic_failover_restores_identical_state(tmp_path):
    out = run("port_elastic_failover.py", "--device", "cpu",
              tmp_path=tmp_path)
    assert "resize plan: 7 pods -> 4" in out
    assert "restored state identical: True" in out
    assert re.search(r"final loss [\d.]+ at step 40", out)


@pytest.mark.parametrize("name", ["port_serve_lm", "port_train_lm",
                                  "port_elastic_failover"])
def test_examples_default_to_the_card(name, tmp_path, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would run")
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        mod.main([])
