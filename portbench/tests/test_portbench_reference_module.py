"""Each configuration names its reference module, and nothing else in
the benchmark knows an architecture: a module written as new files (the
probe, `probe_reference.py`, whose layer records its place and the
stack's input) is found by a configuration's name for it and driven
through the judge, the control and a whole run; it sees every layer
once, in order, with the embedding of the batch as the stack's input;
the numbers it gives are `ops`' own; and a configuration that names no
module is refused."""
import hashlib
import json
import shutil
import time
from pathlib import Path

import pytest
import torch

from portbench_small import CELLS, ROOT, run_small, small_run_as, small_tree, one_thread  # noqa: F401
from portbench import check, harness, weights
from portbench.reference import ops

PROBE = Path(__file__).with_name("probe_reference.py")
PREFILL = CELLS["qwen3-moe-30b-a3b"]


def with_probe(bench: Path) -> Path:
    """``bench`` with the probe as ``reference/probe.py``."""
    (bench / "reference").mkdir(parents=True, exist_ok=True)
    shutil.copy(PROBE, bench / "reference" / "probe.py")
    return bench


def n_layers(m: dict) -> int:
    return sum(len(g["layers"]) * g["repeat"] for g in m["groups"])


@pytest.mark.parametrize("config", ["qwen3-moe-30b-a3b", "zamba2-7b"])
def test_the_probe_sees_each_layer_in_order_with_the_embedding(tmp_path,
                                                               config):
    from repro_torch.models import model as M
    m = dict(small_run_as(config), dtype="float32")
    probe = harness.reference_module(
        "probe-config", {"reference": "probe", "run_as": m},
        with_probe(tmp_path / "portbench"))
    cfg = harness.program_config({"run_as": m}, "cpu")
    params = weights.draw(3, M.model_param_specs(cfg), torch.float32, "cpu")
    tokens = torch.randint(0, m["vocab_size"], (2, 24),
                           generator=torch.Generator().manual_seed(4))
    L = n_layers(m)
    assert L == (7 if config == "zamba2-7b" else 2)

    def seen(x0):
        calls = list(probe.CALLS)
        probe.CALLS.clear()
        assert [at.index for at, *_ in calls] == list(range(L))
        assert [at for at, *_ in calls] == list(check.places(m))
        for _, got, _ in calls:
            assert got.dtype == x0.dtype and torch.equal(got, x0)

    # the control: its own embedding, rounded as it keeps its residual
    logits, layers, states = check.control_prefill(probe, m, params, tokens)
    seen(ops.embed(params, tokens).to(torch.bfloat16))
    want = check.control_prefill(ops, m, params, tokens)
    assert torch.equal(logits, want[0])
    assert all(torch.equal(a, b) for got, ref in zip(layers, want[1])
               for a, b in zip(got, ref))
    # the judge: the reference's own embedding, in float32
    got = check.judge_prefill(probe, m, params, tokens, logits, layers,
                              states)
    seen(ops.embed(params, tokens))
    assert got == check.judge_prefill(ops, m, params, tokens, *want)
    assert got["layer_err"] > 0          # the control is judged, not excused


def digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_configuration_names_its_reference_as_new_files(tmp_path):
    """A configuration whose reference module reads the layer's index and
    the stack's input joins with new files and manifest entries alone,
    and a traced run of its cell drives the module through the judge and
    the ``mfu.prefill`` reader."""
    tree = small_tree(tmp_path, "qwen3-moe-30b-a3b")
    bench = tree / "portbench"
    before = digest(bench)
    with_probe(bench)
    conf = json.loads((bench / "configs" /
                       "qwen3-moe-30b-a3b.json").read_text())
    conf["reference"] = "probe"
    (bench / "configs" / "qwen3-probe.json").write_text(json.dumps(conf))
    cell = "qwen3-probe.prefill_8x2048"
    (bench / "limits" / f"{cell}.json").write_text(
        (bench / "limits" / f"{PREFILL}.json").read_text())
    man = json.loads((tree / "BENCHMARK.json").read_text())
    man["configs"].append(dict(man["configs"][0], name="qwen3-probe",
                               file="portbench/configs/qwen3-probe.json"))
    man["workloads"].append({"name": cell, "config": "qwen3-probe",
                             "traffic": "prefill_8x2048", "chips": 1,
                             "why": "the probe"})
    for m in man["end_to_end"] + man["per_layer"]:
        if PREFILL in m.get("workloads", ()):
            m["workloads"].append(cell)
    (tree / "BENCHMARK.json").write_text(json.dumps(man))
    after = digest(bench)
    assert all(after[p] == h for p, h in before.items())   # nothing edited
    out = run_small(tree, cell, trace=True)
    assert out["correct"], out["checks"]
    assert out["metrics"]["mfu.prefill"]["value"] > 0
    probe = harness.load_file(bench / "reference" / "probe.py",
                              "portbench_reference")
    L = n_layers(conf["run_as"])
    traffic = json.loads((bench / "traffic" /
                          "prefill_8x2048.json").read_text())
    calls = probe.CALLS
    assert [at.index for at, *_ in calls] == \
        list(range(L)) * traffic["check_batches"]
    for at, x0, x in calls:     # the embedding of the batch judged
        assert x0.dtype == torch.float32
        if at.index == 0:
            assert torch.equal(x0, x.float())


def test_a_configuration_without_a_reference_is_refused(tmp_path):
    tree = small_tree(tmp_path, "qwen3-moe-30b-a3b")
    path = tree / "portbench" / "configs" / "qwen3-moe-30b-a3b.json"
    conf = json.loads(path.read_text())
    del conf["reference"]
    path.write_text(json.dumps(conf))
    with pytest.raises(ValueError, match="'qwen3-moe-30b-a3b' names no "
                                       "reference module"):
        harness.Context(PREFILL, 1, 0.0, False, "cpu", time.time(), tree,
                        tree / "portbench")


@pytest.mark.parametrize("config", sorted(CELLS))
def test_every_configuration_names_a_module_with_the_contract(config):
    conf = harness.config_file(harness.manifest(ROOT), config)
    assert conf["reference"] == "ops" and "reference" not in conf["run_as"]
    ref = harness.reference_module(config, conf)
    for name in ("embed", "logits", "layer", "loss", "param_count",
                 "model_flops"):
        assert callable(getattr(ref, name)), name
