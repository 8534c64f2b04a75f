"""`repro_torch` stands alone: it imports neither jax nor the reference
package, its entry points run on the card unless the caller asks for the
CPU, and a CUDA-path request never falls back to the plain versions."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro", "benchmarks")


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def test_import_all_of_repro_torch_without_jax_or_reference():
    """With jax blocked, every module of the port imports, and no module
    of the reference package gets loaded."""
    script = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        f"mods = {list(_port_modules())!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'repro' or "
        "m.startswith('repro.') or m == 'benchmarks' or "
        "m.startswith('benchmarks.'))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.strip()) >= 17


EXAMPLES = sorted(str(p.relative_to(ROOT))
                  for p in (ROOT / "examples").glob("port_*.py"))


def test_every_reference_example_but_quickstart_has_a_port():
    assert EXAMPLES == [f"examples/port_{n}.py" for n in (
        "elastic_failover", "serve_lm", "train_lm", "volunteer_cloud")]


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"] + EXAMPLES))
def test_no_import_of_jax_or_reference(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_hub_defaults_to_cuda_and_raises_without_it():
    from repro_torch.core.swarm_arrays import SwarmHub
    if torch.cuda.is_available():
        assert SwarmHub().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        SwarmHub()
    with pytest.raises(RuntimeError, match="cuda"):
        from repro_torch.scenarios import scenario_vii
        scenario_vii(verbose=False, n_volunteers=4, batched=True)
    assert SwarmHub(device="cpu").device.type == "cpu"


@pytest.mark.parametrize("device", ["tpu", "meta"])
def test_unknown_devices_raise(device):
    from repro_torch.core.swarm_arrays import SwarmHub
    with pytest.raises((ValueError, RuntimeError)):
        SwarmHub(device=device)


@pytest.mark.parametrize("device", ["tpu", "meta"])
def test_swarm_state_checks_its_device(device):
    """`SwarmState` is public: it defaults to the card, raises without one,
    and refuses devices other than cuda and cpu."""
    from types import SimpleNamespace
    from repro_torch.core.swarm_arrays import SwarmState
    manifest = SimpleNamespace(n_pieces=4)
    with pytest.raises((ValueError, RuntimeError)):
        SwarmState("app", manifest, device=device)
    if torch.cuda.is_available():
        assert SwarmState("app", manifest).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            SwarmState("app", manifest)
    assert SwarmState("app", manifest, device="cpu").device.type == "cpu"


def test_wrappers_refuse_other_devices():
    from repro_torch.core import swarm_kernels as sk
    counts = torch.zeros(4, dtype=torch.int64, device="meta")
    offsets = torch.zeros(2, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sk.rarest_keys(counts, offsets, 4)
    with pytest.raises(ValueError, match="mixed devices"):
        sk.rarest_keys(torch.zeros(4, dtype=torch.int64), offsets, 4)


def test_launchers_take_only_cuda_tensors():
    """The launch half of each wrapper refuses CPU tensors: only the
    public function routes a CPU tensor to the plain version."""
    from repro_torch.core import swarm_kernels as sk
    before = dict(sk.LAUNCHES)
    c = torch.zeros(4, dtype=torch.int64)
    o = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        sk._launch_rarest_keys(c, o, 4, None, None, 0)
    with pytest.raises(ValueError, match="CUDA"):
        sk._launch_island_has(torch.zeros((3, 4), dtype=torch.uint8),
                              torch.zeros((2, 3), dtype=torch.uint8))
    u8, i64 = torch.uint8, torch.int64
    planes = (torch.zeros((6, 4), dtype=u8), torch.zeros(6, dtype=u8),
              torch.zeros(6, dtype=u8), torch.zeros(6, dtype=i64))
    with pytest.raises(ValueError, match="CUDA"):
        sk._launch_island_cost_rows(*planes, 5, torch.zeros(3, dtype=i64),
                                    torch.zeros((2, 2), dtype=i64))
    meta = tuple(t.to("meta") for t in planes)
    with pytest.raises(ValueError, match="unsupported device"):
        sk.island_cost_rows(*meta, 5, torch.zeros(3, dtype=i64,
                                                  device="meta"),
                            torch.zeros((2, 2), dtype=i64, device="meta"))
    with pytest.raises(ValueError, match="mixed devices"):
        sk.island_cost_rows(*meta, 5, torch.zeros(3, dtype=i64),
                            torch.zeros((2, 2), dtype=i64))
    i32 = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        sk._launch_match_requests(
            i32, torch.zeros(2, dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32),
            torch.zeros((2, 3), dtype=torch.int32),
            torch.zeros((2, 3), dtype=torch.uint8),
            torch.zeros((2, 3), dtype=torch.int32),
            torch.zeros((5, 4), dtype=torch.uint8),
            torch.zeros(5, dtype=torch.uint8))
    for n in (4, 100):              # the warp and sort routes
        with pytest.raises(ValueError, match="CUDA"):
            sk._launch_rarest_orders(
                torch.zeros(n, dtype=torch.int64), o, n,
                torch.zeros((2, n), dtype=torch.uint8), None, 0)
    for max_degree in (3, 600):     # the register and wide routes
        with pytest.raises(ValueError, match="CUDA"):
            sk._launch_match_requests_ragged(
                i32, torch.zeros(2, dtype=torch.int32),
                torch.tensor([0, 1, 3], dtype=torch.int32),
                torch.zeros(3, dtype=torch.int32),
                torch.zeros(3, dtype=torch.uint8),
                torch.zeros(3, dtype=torch.int32),
                torch.zeros(2, dtype=torch.int32),
                torch.zeros(2, dtype=torch.int32),
                torch.zeros((5, 4), dtype=torch.uint8),
                torch.zeros(5, dtype=torch.uint8), max_degree)
    assert sk.LAUNCHES == before


def test_training_entry_points_default_to_cuda(tmp_path):
    """The trainer, the train state, the checkpoint restore onto specs,
    `from_swarm` and the train launcher run on the card unless the caller
    asks for the CPU: without a card they raise, and "cpu" runs."""
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.configs.base import get_config, reduced_config
    from repro_torch.launch import train as launch_train
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.serving.engine import ServeConfig, ServingEngine
    from repro_torch.training.train_state import (init_train_state,
                                                  train_state_specs)
    from repro_torch.training.trainer import Trainer, TrainerConfig
    cfg = reduced_config(get_config("granite-8b")).replace(
        vocab_size=64, d_model=32, num_heads=4, num_kv_heads=2, head_dim=8,
        d_ff=64)
    tc = TrainerConfig(batch=2, seq=8, steps=1, log_every=0)
    argv = ["--arch", "granite-8b", "--reduced", "--steps", "1", "--batch",
            "2", "--seq", "8"]
    store = CheckpointStore(str(tmp_path / "ck"))
    store.save(0, init_train_state(0, cfg, device="cpu"))
    specs = train_state_specs(cfg)
    assert init_train_state(0, cfg, device="cpu")["step"].device.type == \
        "cpu"
    assert store.restore(specs, device="cpu")[0]["step"].device.type == "cpu"
    assert len(launch_train.main(argv + ["--device", "cpu"])) == 1
    if torch.cuda.is_available():
        assert Trainer(cfg, AdamWConfig(), tc).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(cfg, AdamWConfig(), tc)
    with pytest.raises(RuntimeError, match="cuda"):
        init_train_state(0, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        store.restore(specs)
    with pytest.raises(RuntimeError, match="cuda"):
        launch_train.main(argv)
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine.from_swarm(cfg, specs["params"], ServeConfig(),
                                 agent=None, app_id="a")
    assert Trainer(cfg, AdamWConfig(), tc, device="cpu").device.type == "cpu"


def test_mesh_and_table_entry_points_default_to_cuda(tmp_path):
    """The torrent restore and the pod fan-out of `from_swarm` run on the
    card unless asked for the CPU; the paper's tables and the ring's cost
    models take no device."""
    from types import SimpleNamespace
    from repro_torch import scenarios
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.parallel import weight_torrent as wt
    from repro_torch.parallel.sharding import ParamSpec
    from repro_torch.serving.engine import ServeConfig, ServingEngine
    specs = {"w": ParamSpec((2, 3), (None, None))}
    store = CheckpointStore(str(tmp_path / "ck"))
    store.save(0, {"w": torch.ones(2, 3)})
    got, _ = store.restore_distributed(specs, None, device="cpu")
    assert got["w"].device.type == "cpu"
    assert wt.axis_group(None, "pod") is None
    assert wt.axis_group(SimpleNamespace(mesh_dim_names=("data",)),
                         "pod") is None
    assert "device" not in scenarios.table1.__code__.co_varnames
    assert wt.broadcast_cost_model(1e9, 4)["speedup"] > 1
    if torch.cuda.is_available():
        return
    pod = SimpleNamespace(mesh_dim_names=("pod",), shape=(4,))
    with pytest.raises(RuntimeError, match="cuda"):
        store.restore_distributed(specs, None)
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine.from_swarm(None, specs, ServeConfig(), agent=None,
                                 app_id="a", mesh=pod)


def test_build_without_nvcc_raises(tmp_path):
    """A CUDA-path request with no way to build the library raises: there
    is no fallback to the plain versions."""
    from repro_torch import kernels_build
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels_build.build(nvcc=str(tmp_path / "no-nvcc"),
                            build_dir=tmp_path / "build")
    assert not (tmp_path / "build").exists()
