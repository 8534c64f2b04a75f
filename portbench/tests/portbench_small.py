"""A copy of the benchmark's tree with a cell's configuration and traffic
cut to a size the CPU runs in seconds, for the tests.  The widths, the
vocabulary and the layer count shrink; every kind of layer of the
configuration stays."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

SMALL = {
    "zamba2-7b": dict(d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
                      shared_attn_heads=4, shared_attn_kv_heads=4,
                      vocab_size=256, ssm_state=16, ssm_head_dim=16,
                      ssd_chunk=16, repeats=(1, 1)),
    "qwen3-moe-30b-a3b": dict(d_model=64, num_heads=4, num_kv_heads=2,
                              head_dim=16, vocab_size=256, num_experts=8,
                              experts_per_token=2, moe_d_ff=32,
                              repeats=(2,)),
}
CELLS = {"qwen3-moe-30b-a3b": "qwen3-moe-30b-a3b.prefill-8x2048",
         "qwen3-moe-30b-a3b.stage4": "qwen3-moe-30b-a3b.train-2x2048"}
# The port's zamba2-7b layout, which no cell runs: the reference's SSD and
# shared-attention layers and the frozen counts are tested on it.
LAYOUTS = {"zamba2-7b": Path(__file__).with_name("zamba2_port_layout.json")}


def run_as(config: str) -> dict:
    """The ``run_as`` of a configuration file, or of a layout above."""
    path = LAYOUTS.get(config, ROOT / "portbench" / "configs" /
                       f"{config}.json")
    return json.loads(path.read_text())["run_as"]


def small_run_as(config: str) -> dict:
    """The configuration's ``run_as`` cut to SMALL."""
    m = dict(run_as(config))
    cut = dict(SMALL[config.split(".")[0]])
    reps = cut.pop("repeats")
    m.update(cut, groups=[dict(g, repeat=r)
                          for g, r in zip(m["groups"], reps)])
    return m


# A training cell's small copy runs in float32, where the program meets
# the reference to ~1e-5 (in bfloat16 a random model this small moves
# its gradients' norms by 5-160% from float32: no limit would separate
# a fault there); its limits are set for that size, from CPU readings.
TRAIN_SMALL = {"dtype": "float32",
               "limits": {"loss_err": 1e-4, "grad_err": 1e-3,
                          "update_err": 1e-3, "update_dir_err": 1e-3,
                          "layer_err": 1e-3, "route_err": 0}}


def small_tree(dest: Path, config: str, batch: int = 2, seq: int = 32
               ) -> Path:
    """``dest`` holding BENCHMARK.json and portbench/ with ``config``'s
    file and its cells' traffic cut small; returns ``dest``.  A training
    configuration runs as TRAIN_SMALL says."""
    shutil.copytree(ROOT / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    path = dest / "portbench" / "configs" / f"{config}.json"
    conf = json.loads(path.read_text())
    conf["run_as"] = small_run_as(config)
    train = "param_dtype" in conf["run_as"]
    if train:
        conf["run_as"]["dtype"] = TRAIN_SMALL["dtype"]
    path.write_text(json.dumps(conf))
    for w in man["workloads"]:
        if w["config"] == config:
            if train:
                lim = {k: v for k, v in TRAIN_SMALL["limits"].items()
                       if k != "route_err" or "num_experts" in conf["run_as"]}
                (dest / "portbench" / "limits" /
                 f"{w['name']}.json").write_text(json.dumps(lim))
            tp = dest / "portbench" / "traffic" / f"{w['traffic']}.json"
            t = json.loads(tp.read_text())
            t.update(batch=batch, seq=seq, pool=4, profile_steps=1)
            tp.write_text(json.dumps(t))
    (dest / "BENCHMARK.json").write_text(json.dumps(man))
    return dest


def run_small(tree: Path, cell: str, seed: int = 2 ** 31 + 17,
              trace: bool = False) -> dict:
    from portbench import harness
    return harness.run(cell, seed, 0.5, trace, device="cpu", root=tree,
                       bench=tree / "portbench")


@pytest.fixture(autouse=True)
def one_thread():
    """Each test on one CPU thread: the suite runs several workers at
    once, and bf16 on many threads each slows them all."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
