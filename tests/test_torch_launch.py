"""The launch toolchain on meta tensors (`repro_torch.launch.specs`,
`op_analysis`, `dryrun`, `roofline`, `report`) against the reference's
`repro.launch` modules and against a measured run, on the CPU.

  * `model_flops` equals the reference's on every (arch, shape) pair;
    `collective_link_bytes` equals its on the same op lists;
  * every leaf of `launch.specs` is the local block of the reference's
    `step_args_abstract` shard shape (``sharding.shard_shape``) on an
    Auto (2, 4) mesh of 8 forced host devices, for reduced architectures
    x {train, prefill, decode}; the reference runs in a subprocess;
  * the kernels' meta routes: `flash_fwd` and `ssd_scan` on meta tensors
    give the right shapes and dtypes and count the FLOPs of the closed
    forms, which equal the loops they replace;
  * the fake-group dry run of a reduced zamba2 train step on (2, 2),
    gloo route, counts exactly the collective calls by kind and the wire
    bytes that 4 gloo ranks measure in `collectives.STATS` running it;
  * `dryrun.run_cell` on two reduced cells (train and decode) gives
    ``status: ok``; `roofline` prices a collective by the axes it spans;
    `report` renders the records.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_mesh_serve import run_ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
KINDS = ("train", "prefill", "decode")
# the small cells: (seq_len, global_batch)
SMALL = {"train": (64, 8), "prefill": (64, 8), "decode": (64, 8)}


# ------------------------- model flops, link bytes ------------------------- #
def test_model_flops_equal_the_reference_on_every_cell():
    from repro.configs.base import ARCH_IDS as J_ARCHS, SHAPES as J_SHAPES
    from repro.launch import roofline as JR
    from repro_torch.configs.base import ARCH_IDS, SHAPES
    from repro_torch.launch import roofline as R
    assert list(ARCH_IDS) == list(J_ARCHS)
    assert list(SHAPES) == list(J_SHAPES)
    n = 0
    for arch in ARCH_IDS:
        for shape in SHAPES:
            want = JR.model_flops(arch, shape)
            assert R.model_flops(arch, shape) == pytest.approx(
                want, rel=1e-12), (arch, shape)
            assert want > 0
            n += 1
    assert n == 40


def _op_lists():
    """Seeded random op lists over the reference's collective kinds, and
    one of a traced step's."""
    from repro.launch.hlo_analysis import COLLECTIVES
    rng = np.random.default_rng(3)
    lists = []
    for _ in range(20):
        ops = []
        for _ in range(int(rng.integers(1, 12))):
            ob = int(rng.integers(0, 1 << 30))
            ops.append({"kind": str(rng.choice(COLLECTIVES)),
                        "operand_bytes": ob,
                        "out_bytes": int(ob * rng.choice([1, 2, 8, 0.125])),
                        "group": int(rng.choice([0, 1, 2, 4, 8, 32])),
                        "axes": ["model"],
                        "count": float(rng.integers(1, 100))})
        lists.append(ops)
    return lists


@pytest.mark.parametrize("which", ["random", "traced"])
def test_collective_link_bytes_equal_the_reference(which, dry_runs):
    from repro.launch.hlo_analysis import collective_link_bytes as ref
    from repro_torch.launch.op_analysis import collective_link_bytes
    lists = (_op_lists() if which == "random" else
             [dry_runs["gloo"]["analysis"]["coll_ops"],
              dry_runs["train"]["analysis"]["coll_ops"],
              dry_runs["decode"]["analysis"]["coll_ops"]])
    for ops in lists:
        assert ops
        assert collective_link_bytes(ops) == ref(ops)


# ------------------------------- specs ------------------------------------ #
_SPECS_REFERENCE = r"""
import json, sys
import jax
from jax.sharding import AxisType
sys.path.insert(0, sys.argv[2])
import test_torch_launch as T
from repro.configs.base import ARCH_IDS, ShapeConfig, get_config, reduced_config
from repro.launch.specs import step_args_abstract

mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)

def flat(prefix, tree, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            flat(f"{prefix}/{k}" if prefix else k, tree[k], out)
    else:
        out[prefix] = list(tree.sharding.shard_shape(tree.shape))

out = {}
for arch in ARCH_IDS:
    cfg = reduced_config(get_config(arch))
    for kind in T.KINDS:
        S, B = T.SMALL[kind]
        args = step_args_abstract(cfg, ShapeConfig(kind, S, B, kind), mesh)
        for i, a in enumerate(args):
            flat(f"{arch}|{kind}|{i}", a, out)
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def reference_specs(tmp_path_factory):
    path = tmp_path_factory.mktemp("specs_ref") / "specs.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           os.environ.get("PYTHONPATH",
                                                          "")]))
    r = subprocess.run([sys.executable, "-c", _SPECS_REFERENCE, str(path),
                        str(ROOT / "tests")], env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(path.read_text())


def _flat(prefix, tree, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flat(f"{prefix}/{k}" if prefix else k, tree[k], out)
    elif isinstance(tree, torch.Tensor):
        assert tree.device.type == "meta", prefix
        out[prefix] = list(tree.shape)


@pytest.mark.parametrize("kind", KINDS)
def test_specs_are_the_reference_shard_shapes(reference_specs, kind):
    """Each leaf's local block equals the reference's shard shape on an
    Auto (2, 4) mesh.  The AdamW moments are the params' blocks; the
    reference's moment specs drop the FSDP opt-out (``fsdp_dim=-2``), so
    its moments differ from its params exactly at the opted-out leaves
    that its FSDP axis then cuts."""
    from repro_torch.configs.base import (ARCH_IDS, ShapeConfig, get_config,
                                          reduced_config)
    from repro_torch.launch.specs import step_args_abstract
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import tree_leaves_with_path
    mesh = {"data": 2, "model": 4}
    S, B = SMALL[kind]
    n = 0
    for arch in ARCH_IDS:
        cfg = reduced_config(get_config(arch))
        ours = {}
        for i, a in enumerate(step_args_abstract(
                cfg, ShapeConfig(kind, S, B, kind), mesh)):
            _flat(f"{arch}|{kind}|{i}", a, ours)
        theirs = {k: v for k, v in reference_specs.items()
                  if k.startswith(f"{arch}|{kind}|")}
        assert ours.keys() == theirs.keys(), arch
        opted_out = {p.replace(".", "/") for p, s in tree_leaves_with_path(
            M.model_param_specs(cfg)) if s.fsdp_dim == -2}
        moved = set()
        for path, shape in ours.items():
            head = f"{arch}|{kind}|0/opt/"
            if path.startswith(head):
                leaf = path[len(head):].split("/", 1)[1]
                param = theirs[f"{arch}|{kind}|0/params/{leaf}"]
                assert shape == param, path
                if theirs[path] != param:
                    moved.add(leaf)
            else:
                assert shape == theirs[path], path
            n += 1
        assert moved <= opted_out, (arch, moved)
    assert n > 300


# ------------------------------ meta routes ------------------------------- #
def live_pairs_loop(Sq, Skv, causal, window):
    n = 0
    for qpos in range(Sq):
        hi = min(Skv - 1, qpos) if causal else Skv - 1
        lo = max(0, qpos - window + 1) if window else 0
        n += max(0, hi - lo + 1)
    return n


def ssd_ops_loop(B, S, H, P, N, chunk):
    L = min(chunk, S)
    ops = 0
    for t0 in range(0, S, L):
        lc = min(L, S - t0)
        ops += lc * (lc + 1) * (N + P) + 4 * lc * N * P
    return ops * B * H


def test_closed_forms_equal_the_loops():
    from repro_torch.kernels.flash_attention.kernel import live_pairs
    from repro_torch.kernels.ssd.kernel import ssd_ops
    rng = np.random.default_rng(0)
    cases = [(0, 5, True, 0), (5, 0, False, 0), (1, 1, True, 1),
             (2048, 2048, True, 0), (2048, 2048, False, 0),
             (2048, 2048, True, 512), (100, 37, True, 0), (37, 100, True, 9),
             (100, 37, False, 9), (64, 64, True, 200), (300, 50, True, 20)]
    for _ in range(300):
        cases.append((int(rng.integers(0, 200)), int(rng.integers(0, 200)),
                      bool(rng.integers(2)), int(rng.choice(
                          [0, 1, 2, int(rng.integers(1, 250))]))))
    for c in cases:
        assert live_pairs(*c) == live_pairs_loop(*c), c
    for S in (1, 7, 16, 255, 256, 257, 2048, 4095):
        for chunk in (1, 16, 64, 256, 5000):
            args = (2, S, 3, 64, 16, chunk)
            assert ssd_ops(*args) == ssd_ops_loop(*args), args


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Skv,Hq,Hkv,D,causal,window", [
    (64, 64, 4, 2, 16, True, 0), (33, 70, 8, 8, 64, False, 0),
    (128, 128, 6, 2, 112, True, 32)])
def test_flash_fwd_meta_route(dtype, Sq, Skv, Hq, Hkv, D, causal, window):
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels.flash_attention import kernel as fk
    B = 2
    q = torch.empty((B, Sq, Hq, D), dtype=dtype, device="meta")
    k = torch.empty((B, Skv, Hkv, D), dtype=dtype, device="meta")
    before = dict(fk.LAUNCHES)
    with FlopCounterMode(display=False) as fc:
        out, lse = fk.flash_fwd(q, k, k, causal=causal, window=window)
    assert (out.device.type, out.shape, out.dtype) == ("meta", q.shape, dtype)
    assert (lse.shape, lse.dtype) == ((B, Sq, Hq), torch.float32)
    assert fc.get_total_flops() == fk.flash_fwd_flops(
        B, Sq, Skv, Hq, D, causal, window) == 4 * B * Hq * D * \
        live_pairs_loop(Sq, Skv, causal, window)
    assert fk.LAUNCHES == before      # a meta call launches nothing
    with pytest.raises(ValueError, match="do not fit"):
        fk.flash_fwd(q, torch.empty((B, Skv, 3, D), dtype=dtype,
                                    device="meta"), k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,H,P,G,N,chunk", [(64, 4, 16, 1, 16, 16),
                                             (100, 8, 64, 2, 64, 32)])
def test_ssd_scan_meta_route(dtype, S, H, P, G, N, chunk):
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels.ssd import kernel as sk
    B = 2
    m = lambda *s, dt=dtype: torch.empty(s, dtype=dt,  # noqa: E731
                                         device="meta")
    x, Bm = m(B, S, H, P), m(B, S, G, N)
    dt, A = m(B, S, H, dt=torch.float32), m(H, dt=torch.float32)
    before = dict(sk.LAUNCHES)
    with FlopCounterMode(display=False) as fc:
        y, fin = sk.ssd_scan(x, dt, A, Bm, Bm, chunk)
    assert (y.device.type, y.shape, y.dtype) == ("meta", x.shape, dtype)
    assert (fin.shape, fin.dtype) == ((B, H, P, N), torch.float32)
    assert fc.get_total_flops() == sk.ssd_ops(B, S, H, P, N, chunk) == \
        ssd_ops_loop(B, S, H, P, N, chunk)
    assert sk.LAUNCHES == before
    with pytest.raises(TypeError):
        sk.ssd_scan(x, m(B, S, H, dt=torch.bfloat16), A, Bm, Bm, chunk)


def test_custom_ops_have_no_cpu_route():
    """The CPU takes the plain versions in the wrappers; the custom ops
    themselves launch on CUDA only and raise on CPU tensors."""
    q = torch.zeros((1, 4, 2, 8))
    with pytest.raises(NotImplementedError):
        torch.ops.repro_torch.flash_fwd(q, q, q, True, 0)
    x = torch.zeros((1, 4, 2, 8))
    b = torch.zeros((1, 4, 1, 4))
    with pytest.raises(NotImplementedError):
        torch.ops.repro_torch.ssd_scan(x, torch.zeros((1, 4, 2)),
                                       torch.zeros(2), b, b, 4)


# -------------------- dry run against a measured run ---------------------- #
ZAMBA_B, ZAMBA_S = 4, 64


def _small(kind):
    from repro_torch.configs.base import ShapeConfig
    if kind == "train":
        return ShapeConfig("train_small", ZAMBA_S, ZAMBA_B, "train")
    return ShapeConfig(f"{kind}_small", *SMALL[kind][::1], kind)


def dryrun_rank(rank):
    """In a process of its own: the dry runs of the reduced zamba2 train
    step on (2, 2) (gloo and nccl routes) and of a reduced decode cell,
    and the traces of that train step under remat "full" and "dots"."""
    from repro_torch.launch import dryrun
    out = {}
    for key, arch, kind, route in (
            ("gloo", "zamba2-7b", "train", "gloo"),
            ("train", "zamba2-7b", "train", "nccl"),
            ("decode", "seamless-m4t-medium", "decode", "nccl")):
        out[key] = dryrun.run_cell(arch, _small(kind).name, mesh_shape=(2, 2),
                                   reduced=True, shape=_small(kind),
                                   route=route)
    cfg = dryrun.lower_cell_config("zamba2-7b", reduced=True)
    for remat in ("full", "dots"):
        out[remat] = dryrun.trace_cell(cfg.replace(remat=remat),
                                       _small("train"),
                                       dryrun.make_mesh(shape=(2, 2)))
    return out


def measured_rank(rank):
    """One train step of the same reduced zamba2 on 4 gloo ranks: this
    rank's `collectives.STATS`."""
    from repro_torch.launch.dryrun import lower_cell_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.models.convert import shard_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.sharding import DEFAULT_RULES, init_params_numpy
    from repro_torch.training.train_state import make_train_step
    mesh = make_host_mesh(2, 2)
    cfg = lower_cell_config("zamba2-7b", reduced=True)
    specs = M.model_param_specs(cfg)
    params = shard_params(init_params_numpy(0, specs), specs, mesh,
                          DEFAULT_RULES, device="cpu")
    zeros = lambda t: {k: zeros(v) for k, v in t.items()} \
        if isinstance(t, dict) else torch.zeros_like(t)  # noqa: E731
    state = {"params": params, "opt": {"m": zeros(params),
                                       "v": zeros(params)},
             "step": torch.zeros((), dtype=torch.int32)}
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (ZAMBA_B, ZAMBA_S + 1)).astype(np.int32))
    step = make_train_step(cfg, AdamWConfig(), mesh)
    C.reset_stats()
    _, met = step(state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    assert np.isfinite(float(met["loss"]))
    return {k: v for k, v in C.STATS.items()
            if k not in ("seconds", "hop_bytes", "hop_calls")}


@pytest.fixture(scope="module")
def dry_runs(tmp_path_factory):
    return run_ranks(dryrun_rank, 1, tmp_path_factory.mktemp("dryrun"),
                     limit=300.0)[0]


def test_dry_run_cells_are_ok(dry_runs):
    for key in ("train", "decode", "gloo"):
        rec = dry_runs[key]
        assert rec["status"] == "ok", rec.get("traceback")
        a = rec["analysis"]
        assert a["n_devices"] == 4
        assert a["flops"] >= a["dot_flops"] > 0
        assert a["bytes_accessed"] > 0 and a["collective_bytes"] > 0
        assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"]
        assert rec["fits"] and rec["micro_steps"] == 1
    # the nccl route reduce-scatters where gloo all-reduces and slices
    assert dry_runs["train"]["analysis"]["stats"].get("psum_scatter", 0) > 0
    assert "psum_scatter" not in dry_runs["gloo"]["analysis"]["stats"]


def test_dry_run_under_remat_dots(dry_runs):
    """remat "dots" on the fake group: fewer FLOPs than "full" (the saved
    products are not computed again) and more than no remat, a peak at
    least as high, and the FSDP gathers recomputed as under "full"."""
    dots, full = dry_runs["dots"], dry_runs["full"]
    none = dry_runs["train"]["analysis"]
    assert none["flops"] < dots["analysis"]["flops"] \
        < full["analysis"]["flops"]
    assert dots["memory"]["peak_bytes"] >= full["memory"]["peak_bytes"]
    assert dots["analysis"]["stats"] == full["analysis"]["stats"]


def test_dry_run_counts_what_gloo_ranks_measure(dry_runs, tmp_path):
    measured = run_ranks(measured_rank, 4, tmp_path, limit=300.0)
    traced = dry_runs["gloo"]["analysis"]["stats"]
    assert measured[0] == traced
    assert traced["wire_bytes"] > 0 and traced["all_gather"] > 0
    assert all(m == measured[0] for m in measured)


def test_roofline_prices_each_axis_and_reports(dry_runs, tmp_path):
    from repro_torch.launch import report, roofline as R
    from repro_torch.launch.mesh import HARDWARE
    op = {"kind": "all-gather", "operand_bytes": 1 << 20,
          "out_bytes": 8 << 20, "group": 8, "count": 2.0}
    link = 2.0 * (7 / 8) * (8 << 20)
    assert R.collective_seconds([dict(op, axes=["model"])]) == pytest.approx(
        link / HARDWARE["nvlink_bandwidth"])
    assert R.collective_seconds([dict(op, axes=["data"])]) == pytest.approx(
        link / HARDWARE["internode_bandwidth"])
    assert R.collective_seconds([dict(op, axes=["data", "model"])]) == \
        pytest.approx(link / HARDWARE["internode_bandwidth"])
    rec = dict(dry_runs["train"], arch="zamba2-7b", shape="train_4k",
               mesh="32x8")
    (tmp_path / "zamba2-7b__train_4k__32x8.json").write_text(json.dumps(rec))
    cells = R.load_cells(str(tmp_path), "32x8")
    assert len(cells) == 1 and cells[0].dominant in ("compute", "memory",
                                                     "collective")
    t = R.roofline_terms(rec["analysis"])
    assert cells[0].compute_s == pytest.approx(
        rec["analysis"]["flops"] / HARDWARE["peak_flops_bf16"])
    assert t["collective_s"] > 0
    assert "| zamba2-7b | train_4k | 32x8 | ok |" in report.dryrun_section(
        str(tmp_path))
