"""Training over a (data, model) mesh: the port's sharded train step,
its collectives' gradients, the `Trainer` on a mesh and a prefill under
`DEFAULT_RULES`, on gloo ranks of this CPU, held against the
reference's own sharded paths.

One module-scoped subprocess runs the reference (`repro`) under **Auto**
meshes of 8 forced host devices (as `tests/test_torch_mesh_serve.py`
builds them: jax 0.9's default Explicit axes make `shard_act` raise) and
writes to an npz file, for each case of `TRAIN`, the loss, the gradient
of every leaf (the reference's `loss_fn` under `sharding_ctx`, as its
`make_train_step` takes it) and the params after one AdamW step of its
sharded `make_train_step`; and the inputs of the reference mesh checks
(`tests/mesh_checks.py`): the vocab-sharded embedding's gradient and
the MoE block's value and gradients, exact and with the int8
all-to-all, under `DEFAULT_RULES` on (2, 4).  The subprocess starts
with the module and runs beside the port's ranks.

Spawned gloo ranks of the port (`run_ranks`) run the same cases from
the same numpy weights (`init_params_numpy`) and are held to the
reference checks' own bounds: loss 1e-4, params 5e-4, each gradient
leaf 1e-3 relative L2, the embedding's gradient 1e-5, the MoE block
1e-3, the int8 all-to-all's value within rel 5e-2 of exact with finite
gradients.  The reduced zamba2 (SSD and shared attention, a 2-layer
group and a tail layer) is also held against the port's single-device
step.  The same ranks hold each collective's backward against the
gradient of the whole-tensor function, `global_norm` and the int8 /
top-k compression on blocks against the whole leaves', and the
`Trainer` on a mesh: resumed equal to an uninterrupted run, its saved
image byte for byte a single-device save of the same state.
"""
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# the reference mesh checks' block inputs (an embedding (64, 32) and
# (4, 8) tokens, the MoE block's (4, 16, 32) input) and the rank harness
from test_torch_mesh_serve import (block_inputs, moe_block_cfg,  # noqa: E402
                                   moe_block_params, run_ranks)

ROOT = Path(__file__).resolve().parents[1]
SEED = 7
TOL_LOSS, TOL_PARAMS, TOL_GRAD = 1e-4, 5e-4, 1e-3
TOL_EMBED_GRAD, TOL_MOE, TOL_INT8 = 1e-5, 1e-3, 5e-2

# name -> (arch, config overrides, mesh, batch, seq); "cut" stands for
# zamba2's pattern cut to a 2-layer group (an SSD layer, then an SSD
# layer with the shared-attention hit) and one tail layer: the full
# pattern's 6-layer group takes the reference ~25 s a mesh to compile
_TINY = {"d_model": 64, "num_heads": 8, "num_kv_heads": 4}
_QWEN = {"d_model": 64, "num_heads": 6, "num_kv_heads": 2, "head_dim": 16,
         "vocab_size": 256}
TRAIN = {
    "internlm2_2x4": ("internlm2-20b", _TINY, (2, 4), 4, 32),
    "internlm2_micro_2x4": ("internlm2-20b", dict(_TINY, micro_steps=2),
                            (2, 4), 4, 32),
    "qwen3_14b_2x4": ("qwen3-14b", _QWEN, (2, 4), 4, 32),
    "qwen3_14b_tp_sp_pad_2x4": ("qwen3-14b", dict(
        _QWEN, tp_sp=True, pad_attn_heads=True), (2, 4), 4, 32),
    "zamba2_2x2": ("zamba2-7b", {"groups": "cut", "remat": "full"}, (2, 2),
                   2, 32),
    "zamba2_1x4": ("zamba2-7b", {"groups": "cut"}, (1, 4), 2, 32),
    "moe_2x2": ("qwen3-moe-30b-a3b", {}, (2, 2), 2, 32),
    "moe_int8_2x2": ("qwen3-moe-30b-a3b", {"moe_a2a_int8": True}, (2, 2),
                     2, 32),
}
PREFILL = ("zamba2-7b", {"groups": "cut"}, (2, 2), 2, 32)


def model_cfg(arch, kw, pkg="repro_torch"):
    if pkg == "repro_torch":
        from repro_torch.configs import base
    else:
        from repro.configs import base
    kw = dict(kw)
    if kw.get("groups") == "cut":
        ssd = base.LayerSpec(mixer="ssd", mlp="none")
        hit = base.LayerSpec(mixer="ssd", mlp="none", shared_attn=True)
        kw["groups"] = (base.GroupSpec((ssd, hit), 1),
                        base.GroupSpec((ssd,), 1))
    return base.reduced_config(base.get_config(arch)).replace(
        dtype="float32", **kw)


def case_cfg(name, pkg="repro_torch"):
    arch, kw, *_ = TRAIN[name]
    return model_cfg(arch, kw, pkg)


def train_inputs(cfg, B, S):
    """(numpy weights, batch {tokens, labels} (B, S) int32), from SEED."""
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import init_params_numpy
    rng = np.random.default_rng(SEED)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return (init_params_numpy(SEED, M.model_param_specs(cfg)),
            {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()})


# ------------------------------ reference --------------------------------- #
_REFERENCE = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
sys.path.insert(0, sys.argv[2])
import test_torch_mesh_train as T
from repro.models import layers as JL, model as JM, moe as jmoe
from repro.optim.adamw import AdamWConfig
from repro.parallel import sharding as JS
from repro.training.train_state import (make_prefill_step, make_train_step,
                                        train_state_specs)
from repro_torch.parallel.sharding import tree_leaves_with_path
out = {}

def mesh_of(shape):
    return jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * len(shape))

def tree(a):
    if isinstance(a, dict):
        return {k: tree(v) for k, v in a.items()}
    return jnp.asarray(a)

def flat(prefix, t):
    for p, a in tree_leaves_with_path(t):
        out[f"{prefix}|{p}"] = np.asarray(a)

for name, (arch, kw, shape, B, S) in T.TRAIN.items():
    cfg = T.case_cfg(name, "repro")
    params, batch = T.train_inputs(T.case_cfg(name), B, S)
    params, batch = tree(params), tree(batch)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
    state = {"params": params, "opt": {"m": zeros, "v": zeros},
             "step": jnp.zeros((), jnp.int32)}
    mesh = mesh_of(shape)

    def loss(p, b):
        with JS.sharding_ctx(mesh, JS.DEFAULT_RULES):
            half = jax.tree_util.tree_map(
                lambda a: a.astype(cfg.act_dtype)
                if a.dtype == jnp.float32 and a.ndim >= 2 else a, p)
            return JM.loss_fn(cfg, half, b)[0]
    with mesh:
        new, met = jax.jit(make_train_step(cfg, AdamWConfig(), mesh))(
            state, batch)
        if cfg.micro_steps == 1:
            flat(f"{name}|grad", jax.jit(jax.grad(loss))(params, batch))
    out[f"{name}|loss"] = np.asarray(met["loss"])
    out[f"{name}|grad_norm"] = np.asarray(met["grad_norm"])
    flat(f"{name}|params", new["params"])

# a prefill under DEFAULT_RULES
arch, kw, shape, B, S = T.PREFILL
cfg = T.model_cfg(arch, kw, "repro")
params, batch = T.train_inputs(T.model_cfg(arch, kw), B, S)
mesh = mesh_of(shape)
caches = JS.init_params(jax.random.PRNGKey(0), JM.cache_specs_tree(cfg, B, S))
def pre(p, b, c):
    with JS.sharding_ctx(mesh, JS.DEFAULT_RULES):
        return JM.prefill(cfg, p, b, c)
with mesh:
    lg, _ = jax.jit(pre)(tree(params), {"tokens": jnp.asarray(batch["tokens"])},
                         caches)
out["prefill|logits"] = np.asarray(lg)

# the reference mesh checks' blocks under DEFAULT_RULES on (2, 4)
b = T.block_inputs()
m24 = mesh_of((2, 4))
cfg_e = T.moe_block_cfg("repro").replace(vocab_size=64)
def g_sh(emb):
    with JS.sharding_ctx(m24, JS.DEFAULT_RULES):
        return jnp.sum(jnp.sin(JL.embed_tokens({"embedding": emb},
                                               b["toks"], cfg_e)))
with m24:
    out["embed|grad"] = np.asarray(jax.jit(jax.grad(g_sh))(b["emb"]))
mp = tree(T.moe_block_params())
for tag, int8 in (("exact", False), ("int8", True)):
    c = T.moe_block_cfg("repro", int8)
    def f(p, x):
        with JS.sharding_ctx(m24, JS.DEFAULT_RULES):
            o, aux = jmoe.moe_block(p, x, c)
            return jnp.sum(o * jnp.cos(o)) + aux
    with m24:
        v, g = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(mp, b["x"])
    out[f"moe_{tag}|value"] = np.asarray(v)
    flat(f"moe_{tag}|grad", g[0])
    out[f"moe_{tag}|grad|x"] = np.asarray(g[1])
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module", autouse=True)
def reference_run(tmp_path_factory):
    """The reference's subprocess, started with the module so it runs
    beside the port's ranks; `reference` waits for it."""
    path = tmp_path_factory.mktemp("mesh_train_ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONHASHSEED="0",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           os.environ.get("PYTHONPATH",
                                                          "")]))
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE, str(path),
                             str(ROOT / "tests")], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    box = {"proc": proc, "path": path}
    yield box
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def reference(reference_run):
    if "out" not in reference_run:
        proc = reference_run["proc"]
        try:
            _, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
        assert proc.returncode == 0, err[-4000:]
        reference_run["out"] = dict(np.load(reference_run["path"]))
    return reference_run["out"]


def ref_tree(reference, prefix):
    n = len(prefix) + 1
    return {k[n:]: v for k, v in reference.items()
            if k.startswith(prefix + "|")}


# ------------------------------- the port --------------------------------- #
def _mesh(shape):
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh(*shape)


def _zeros(tree):
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    return torch.zeros_like(tree, dtype=torch.float32)


def _flat_numpy(tree):
    from repro_torch.parallel.sharding import tree_leaves_with_path
    return {p: t.detach().numpy().copy()
            for p, t in tree_leaves_with_path(tree)}


def _train(name, mesh, rank):
    """One sharded train step of a case on this rank: its loss and grad
    norm; on rank 0 the gathered gradients (one micro-step cases) and the
    gathered params after the step."""
    from repro_torch.models import model as M
    from repro_torch.models.convert import gather_params, shard_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.sharding import DEFAULT_RULES
    from repro_torch.training.train_state import (loss_and_grads,
                                                  make_train_step)
    arch, kw, shape, B, S = TRAIN[name]
    cfg = case_cfg(name)
    specs = M.model_param_specs(cfg)
    full, batch = train_inputs(cfg, B, S)
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    params = shard_params(full, specs, mesh, DEFAULT_RULES, device="cpu")
    out = {}
    if cfg.micro_steps == 1:
        met, grads = loss_and_grads(cfg, params, batch, mesh)
        grads = gather_params(grads, specs, mesh, DEFAULT_RULES)
        out["grads_loss"] = float(met["loss"])
        flat = _flat_numpy(grads)
        out["grad_finite"] = all(bool(np.isfinite(a).all())
                                 for a in flat.values())
        if rank == 0:
            out["grads"] = flat
    state = {"params": params, "opt": {"m": _zeros(params),
                                       "v": _zeros(params)},
             "step": torch.zeros((), dtype=torch.int32)}
    new, met = make_train_step(cfg, AdamWConfig(), mesh)(state, batch)
    out["loss"] = float(met["loss"])
    out["grad_norm"] = float(met["grad_norm"])
    new_params = gather_params(new["params"], specs, mesh, DEFAULT_RULES)
    if rank == 0:
        out["params"] = _flat_numpy(new_params)
    return out


def _members(mesh, axes, rank):
    """The global ranks of ``rank``'s group over ``axes``, in flattened
    order (the first axis major)."""
    names = list(mesh.mesh_dim_names)
    grid = mesh.mesh
    coords = [int(c[0]) for c in torch.nonzero(grid == rank).T]
    idx = tuple(slice(None) if n in axes else coords[i]
                for i, n in enumerate(names))
    kept = [n for n in names if n in axes]
    return grid[idx].permute([kept.index(a) for a in axes]).reshape(
        -1).tolist()


def _whole(kind, axes, dim, mesh, xs):
    """The collective ``kind`` on every rank's input ``xs`` at once, as
    plain tensor ops: every rank's output."""
    out = []
    for r in range(len(xs)):
        mem = _members(mesh, axes, r)
        me, n = mem.index(r), len(mem)
        parts = [xs[m] for m in mem]
        if kind == "psum":
            out.append(sum(parts))
        elif kind == "pmean":
            out.append(sum(parts) / n)
        elif kind == "all_gather":
            out.append(torch.cat(parts, dim))
        elif kind == "psum_scatter":
            out.append(torch.chunk(sum(parts), n, dim)[me])
        else:                   # all_to_all: dim = (split, concat)
            out.append(torch.cat([torch.chunk(p, n, dim[0])[me]
                                  for p in parts], dim[1]))
    return out


COLLECTIVE_CASES = [
    ("psum", "model", None), ("psum", ("data", "model"), None),
    ("pmean", "data", None), ("all_gather", "model", 1),
    ("all_gather", ("model", "data"), 0), ("psum_scatter", "model", 1),
    ("psum_scatter", ("data", "model"), 1), ("all_to_all", "model", (1, 0)),
    ("all_to_all", ("model", "data"), (1, 2)), ("a2a_int8", "model", (1, 0)),
]


def _collective_grads(mesh, rank):
    """Each collective's backward on this rank against the gradient of
    the whole-tensor function, for J = sum over ranks of <P_r, y_r>, and
    its forward (the gloo route) against the whole-tensor function's
    value (the int8 all-to-all's forward is lossy: not held): (case, max
    abs gradient err, max abs value err)."""
    from repro_torch.models.moe import a2a_int8
    from repro_torch.parallel import collectives as C
    world = mesh.mesh.numel()

    def draw(seed, shape):
        return torch.randn(shape, generator=torch.Generator().manual_seed(
            seed))
    out = []
    for kind, axes, dim in COLLECTIVE_CASES:
        ax = (axes,) if isinstance(axes, str) else axes
        xs = [draw(100 + r, (4, 8, 6)).requires_grad_() for r in range(world)]
        plain = "all_to_all" if kind == "a2a_int8" else kind
        with torch.no_grad():
            shapes = [y.shape for y in _whole(plain, ax, dim, mesh, xs)]
        ps = [draw(200 + r, shapes[r]) for r in range(world)]
        x = xs[rank].detach().clone().requires_grad_()
        if kind in ("psum", "pmean"):
            y = getattr(C, kind)(x, axes, mesh)
        elif kind == "all_gather":
            y = C.all_gather(x, axes, mesh, axis=dim)
        elif kind == "psum_scatter":
            y = C.psum_scatter(x, axes, mesh, scatter_dimension=dim)
        elif kind == "all_to_all":
            y = C.all_to_all(x, axes, mesh, *dim)
        else:
            y = a2a_int8(x, axes, mesh, *dim)
        (y * ps[rank]).sum().backward()
        whole = _whole(plain, ax, dim, mesh, xs)
        want = torch.autograd.grad(sum((w * p).sum() for w, p in
                                       zip(whole, ps)), xs)[rank]
        fwd = (float((y - whole[rank]).abs().max()) if plain == kind
               else 0.0)
        out.append((f"{kind} {axes} {dim}",
                    float((x.grad - want).abs().max()), fwd))
    return out


def _norm_and_compression(mesh):
    """`global_norm` and the int8 / top-k compression of this rank's
    blocks of a random gradient tree (reduced internlm2's leaves) against
    the whole tree's: the relative norm error, and the largest
    difference of the gathered compressed grads and error states."""
    from repro_torch.models import model as M
    from repro_torch.models.convert import gather_params, shard_params
    from repro_torch.optim.adamw import global_norm
    from repro_torch.optim.compression import (CompressionConfig,
                                               compress_tree)
    from repro_torch.parallel.sharding import (DEFAULT_RULES,
                                               init_params_numpy)
    from repro_torch.training.train_state import _leaf_axes
    cfg = case_cfg("internlm2_2x4")
    specs = M.model_param_specs(cfg)
    full = {k: v for k, v in init_params_numpy(SEED + 1, specs).items()}
    from repro_torch.models.convert import params_from_reference
    whole = params_from_reference(full, device="cpu")
    local = shard_params(full, specs, mesh, DEFAULT_RULES, device="cpu")
    axes = _leaf_axes(cfg, mesh, DEFAULT_RULES)
    want = float(global_norm(whole))
    out = {"norm": abs(float(global_norm(local, mesh, axes)) - want) / want}
    for scheme in ("int8", "topk"):
        cc = CompressionConfig(scheme=scheme, topk_frac=0.05)
        g1, e1 = compress_tree(whole, None, cc)
        g2, e2 = compress_tree(local, None, cc, mesh=mesh, leaf_axes=axes)
        err = 0.0
        for a, b in ((g1, g2), (e1, e2)):
            b = gather_params(b, specs, mesh, DEFAULT_RULES)
            err = max(err, max(float(np.abs(x - y).max()) for x, y in zip(
                _flat_numpy(a).values(), _flat_numpy(b).values())))
        out[scheme] = err
    return out


def _embed_and_moe(mesh):
    """The reference mesh checks' blocks under `DEFAULT_RULES` on (2, 4):
    the embedding's gradient of sum(sin(x)), and the MoE block's value
    sum(o cos o) + aux and its gradients (the expert weights' FSDP blocks
    gathered as a layer's are, under autograd), exact and int8.  Each
    rank's part of the objective is its block's sum (plus aux / world,
    the aux being the same on every rank), so the ranks' partial
    gradients summed over a leaf's replicas are the objective's."""
    from repro_torch.models import layers as L
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.convert import gather_params, shard_params
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel import sharding as S
    from repro_torch.training.train_state import local_batch
    rules = S.DEFAULT_RULES
    b = {k: torch.as_tensor(v) for k, v in block_inputs().items()}
    out = {}
    cfg_e = moe_block_cfg().replace(vocab_size=64)
    lay = S.logical_to_mesh_axes(mesh, (64, 32), ("vocab", "embed"), rules)
    emb = S.local_shard(b["emb"], lay, mesh).clone().requires_grad_()
    with S.sharding_ctx(mesh, rules, batch=4, seq=8):
        x = L.embed_tokens({"embedding": emb},
                           local_batch({"t": b["toks"]}, 4, mesh, rules)["t"],
                           cfg_e)
        g, = torch.autograd.grad(torch.sin(x).sum(), emb)
    g = C.psum(g, "data", mesh)
    out["embed_grad"] = C.relayout(g, lay, (None, None), mesh).numpy()
    specs = moe_lib.moe_specs(moe_block_cfg())
    world = mesh.mesh.numel()
    for tag, int8 in (("exact", False), ("int8", True)):
        cfg = moe_block_cfg(int8=int8)
        blocks = shard_params(moe_block_params(), specs, mesh, rules,
                              device="cpu")
        blocks = {k: v.requires_grad_() for k, v in blocks.items()}
        p = {k: C.relayout(v, S.param_sharding(mesh, specs[k], rules),
                           S.logical_to_mesh_axes(mesh, specs[k].shape,
                                                  specs[k].logical, rules),
                           mesh)
             for k, v in blocks.items()}
        with S.sharding_ctx(mesh, rules, batch=4, seq=16):
            res = L.residual_spec()
            xl = S.local_shard(b["x"], res, mesh).clone().requires_grad_()
            o, aux = moe_lib.moe_block(p, xl, cfg)
            part = torch.sum(o * torch.cos(o))
            gs = torch.autograd.grad(part + aux / world,
                                     list(blocks.values()) + [xl])
        value = C.psum(part.detach(), ("data", "model"), mesh) + aux
        grads = {}
        for (k, v), gk in zip(blocks.items(), gs):
            lay = S.param_sharding(mesh, specs[k], rules)
            used = {a for e in lay for a in S.entry_axes(e)}
            grads[k] = C.psum(gk, tuple(a for a in ("data", "model")
                                        if a not in used), mesh)
        grads = gather_params(grads, specs, mesh, rules)
        out[f"moe_{tag}"] = {
            "value": float(value),
            "grads": _flat_numpy(grads),
            "grad_x": C.relayout(gs[-1], res, (None, None, None),
                                 mesh).numpy()}
    return out


def _prefill(mesh):
    """A prefill of the reduced zamba2 cut under `DEFAULT_RULES`: the
    whole batch's last logits, on every rank."""
    from repro_torch.models import model as M
    from repro_torch.models.convert import shard_params
    from repro_torch.parallel.sharding import DEFAULT_RULES
    from repro_torch.training.train_state import make_prefill_step
    arch, kw, shape, B, S = PREFILL
    cfg = model_cfg(arch, kw)
    full, batch = train_inputs(cfg, B, S)
    params = shard_params(full, M.model_param_specs(cfg), mesh,
                          DEFAULT_RULES, device="cpu")
    caches = M.init_caches(cfg, B, S, mesh=mesh, rules=DEFAULT_RULES,
                           device="cpu")
    step = make_prefill_step(cfg, mesh, DEFAULT_RULES, return_logits=True)
    tok, _, lg = step(params, {"tokens": torch.as_tensor(batch["tokens"])},
                      caches)
    return {"tokens": tok.numpy(), "logits": lg.numpy()}


TRAINER = ("internlm2-20b", _TINY, (2, 2))


def _trainer(mesh, root, rank):
    """The `Trainer` on a (2, 2) mesh: 4 steps straight; 2 steps saved at
    step 2, then a fresh Trainer resuming to 4.  Returns the losses and,
    on rank 0, both runs' gathered params."""
    from repro_torch.models import model as M
    from repro_torch.models.convert import gather_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training.trainer import Trainer, TrainerConfig
    arch, kw, _ = TRAINER
    cfg = model_cfg(arch, kw)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=4)

    def run(steps, ckpt_dir=None):
        tr = Trainer(cfg, opt, TrainerConfig(
            batch=2, seq=16, steps=steps, ckpt_every=2, ckpt_dir=ckpt_dir,
            log_every=0), mesh=mesh, device="cpu")
        tr.init(seed=3)
        hist = tr.run()
        params = gather_params(tr.state["params"], M.model_param_specs(cfg),
                               mesh, tr.rules)
        return [h["loss"] for h in hist], _flat_numpy(params)
    straight = run(4)
    store = os.path.join(root, "ckpt")
    first = run(2, store)
    second = run(4, store)
    out = {"straight": straight[0], "first": first[0], "second": second[0]}
    if rank == 0:
        out.update(straight_params=straight[1], second_params=second[1],
                   store=store)
    return out


def _job(rank, names, extra, root):
    meshes = {}

    def mesh_of(shape):
        if shape not in meshes:
            meshes[shape] = _mesh(shape)
        return meshes[shape]
    out = {}
    for name in names:
        out[name] = _train(name, mesh_of(TRAIN[name][2]), rank)
    if "blocks" in extra:
        m = mesh_of((2, 4))
        out["collective_grads"] = _collective_grads(m, rank)
        out["norm_compression"] = _norm_and_compression(m)
        out.update(_embed_and_moe(m))
    if "prefill" in extra:
        out["prefill"] = _prefill(mesh_of(PREFILL[2]))
    if "trainer" in extra:
        out["trainer"] = _trainer(mesh_of(TRAINER[2]), root, rank)
    return out


@pytest.fixture(scope="module")
def ranks_2x4(tmp_path_factory):
    names = [n for n, v in TRAIN.items() if v[2] == (2, 4)]
    tmp = tmp_path_factory.mktemp("t24")
    return run_ranks(_job, 8, tmp, names, ("blocks",), str(tmp))


@pytest.fixture(scope="module")
def ranks_4(tmp_path_factory):
    names = [n for n, v in TRAIN.items() if v[2] != (2, 4)]
    tmp = tmp_path_factory.mktemp("t4")
    return run_ranks(_job, 4, tmp, names, ("prefill", "trainer"), str(tmp))


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def check_step(reference, outs, name):
    ref_params = ref_tree(reference, f"{name}|params")
    for out in outs:
        got = out[name]
        assert abs(got["loss"] - float(reference[f"{name}|loss"])) \
            < TOL_LOSS, (name, got["loss"])
    got = outs[0][name]
    assert set(got["params"]) == set(ref_params)
    err = max(float(np.max(np.abs(got["params"][p] - ref_params[p])))
              for p in ref_params)
    assert err < TOL_PARAMS, (name, err)
    if "grads" in got:
        ref_grads = ref_tree(reference, f"{name}|grad")
        worst = max(((rel_l2(got["grads"][p], ref_grads[p]), p)
                     for p in ref_grads))
        assert worst[0] <= TOL_GRAD, (name, worst)


@pytest.mark.parametrize("name", [n for n, v in TRAIN.items()
                                  if v[2] == (2, 4)])
def test_sharded_train_step_matches_the_reference_2x4(ranks_2x4, reference,
                                                      name):
    check_step(reference, ranks_2x4, name)


@pytest.mark.parametrize("name", [n for n, v in TRAIN.items()
                                  if v[2] != (2, 4)])
def test_sharded_train_step_matches_the_reference_4(ranks_4, reference,
                                                    name):
    check_step(reference, ranks_4, name)


def test_collectives_backward_is_the_whole_tensors_gradient(ranks_2x4):
    for out in ranks_2x4:
        for case, err, fwd in out["collective_grads"]:
            assert err <= 1e-5 and fwd <= 1e-5, (case, err, fwd)
    assert len(ranks_2x4[0]["collective_grads"]) == len(COLLECTIVE_CASES)


def test_global_norm_and_compression_on_blocks_match_whole_leaves(
        ranks_2x4):
    for out in ranks_2x4:
        got = out["norm_compression"]
        assert got["norm"] <= 1e-6
        assert got["int8"] == 0.0 and got["topk"] == 0.0


def test_embedding_gradient_matches_the_reference(ranks_2x4, reference):
    for out in ranks_2x4:
        err = float(np.max(np.abs(out["embed_grad"]
                                  - reference["embed|grad"])))
        assert err < TOL_EMBED_GRAD, err


def test_moe_block_value_and_grads_match_the_reference(ranks_2x4,
                                                       reference):
    want = ref_tree(reference, "moe_exact|grad")
    for out in ranks_2x4:
        got = out["moe_exact"]
        assert abs(got["value"] - float(reference["moe_exact|value"])) \
            < TOL_MOE
        for p, g in got["grads"].items():
            assert float(np.max(np.abs(g - want[p]))) < TOL_MOE, p
        assert float(np.max(np.abs(got["grad_x"] - want["x"]))) < TOL_MOE


def test_int8_all_to_all_trains_close_to_exact(ranks_2x4, ranks_4,
                                              reference):
    exact = float(reference["moe_exact|value"])
    for out in ranks_2x4:
        got = out["moe_int8"]
        assert abs(got["value"] - exact) / max(abs(exact), 1e-9) < TOL_INT8
        assert all(np.isfinite(g).all() for g in got["grads"].values())
        assert np.isfinite(got["grad_x"]).all()
        assert got["value"] != out["moe_exact"]["value"]
    # the whole qwen3-moe step: int8 against exact, gradients finite
    for out in ranks_4:
        a, b = out["moe_int8_2x2"]["loss"], out["moe_2x2"]["loss"]
        assert abs(a - b) / abs(b) < TOL_INT8
        assert out["moe_int8_2x2"]["grad_finite"]


@pytest.mark.parametrize("name", ["zamba2_2x2", "zamba2_1x4"])
def test_hybrid_mesh_step_matches_one_device(ranks_4, name):
    """The reduced zamba2 cut: the mesh step's loss and gradients against
    the port's single-device step on the same weights and batch."""
    from repro_torch.models.convert import params_from_reference
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training.train_state import (loss_and_grads,
                                                  make_train_step)
    arch, kw, shape, B, S = TRAIN[name]
    cfg = case_cfg(name)
    full, batch = train_inputs(cfg, B, S)
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    met, grads = loss_and_grads(cfg, params_from_reference(
        full, device="cpu"), batch)
    got = ranks_4[0][name]
    assert abs(got["grads_loss"] - float(met["loss"])) < TOL_LOSS
    want = _flat_numpy(grads)
    worst = max((rel_l2(got["grads"][p], want[p]), p) for p in want)
    assert worst[0] <= TOL_GRAD, worst
    params = params_from_reference(full, device="cpu")
    state = {"params": params, "opt": {"m": _zeros(params),
                                       "v": _zeros(params)},
             "step": torch.zeros((), dtype=torch.int32)}
    new, met = make_train_step(cfg, AdamWConfig())(state, batch)
    assert abs(got["loss"] - float(met["loss"])) < TOL_LOSS
    want = _flat_numpy(new["params"])
    err = max(float(np.max(np.abs(got["params"][p] - want[p])))
              for p in want)
    assert err < TOL_PARAMS, err


def test_prefill_under_default_rules_matches_the_reference(ranks_4,
                                                           reference):
    want = reference["prefill|logits"]
    scale = float(np.max(np.abs(want)))
    for out in ranks_4:
        got = out["prefill"]
        np.testing.assert_array_equal(got["tokens"], want.argmax(-1))
        assert float(np.max(np.abs(got["logits"] - want))) <= 2e-3 * scale


@functools.lru_cache(maxsize=None)
def one_device_trainer(steps, ckpt_dir=None):
    """The `Trainer` of `_trainer` on one device (no mesh), same seed,
    config and batches: its losses, whole state and, with ``ckpt_dir``,
    the store it saved to."""
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training.trainer import Trainer, TrainerConfig
    arch, kw, _ = TRAINER
    tr = Trainer(model_cfg(arch, kw), AdamWConfig(lr=1e-3, warmup_steps=2,
                                                  total_steps=4),
                 TrainerConfig(batch=2, seq=16, steps=steps, ckpt_every=2,
                               ckpt_dir=ckpt_dir, log_every=0),
                 device="cpu")
    tr.init(seed=3)
    hist = tr.run()
    return [h["loss"] for h in hist], tr.state


def test_trainer_on_a_mesh_resumes_equal_to_an_uninterrupted_run(ranks_4):
    """Resumed at step 2, the mesh run equals its uninterrupted self
    exactly, and that run equals one device's Trainer within the step
    bounds (loss and params)."""
    for out in ranks_4:
        t = out["trainer"]
        assert t["first"] + t["second"] == t["straight"]
    t = ranks_4[0]["trainer"]
    for p, a in t["straight_params"].items():
        np.testing.assert_array_equal(t["second_params"][p], a)
    losses, state = one_device_trainer(4)
    assert len(losses) == len(t["straight"]) == 4
    for got, want in zip(t["straight"], losses):
        assert abs(got - want) < TOL_LOSS, (t["straight"], losses)
    want = _flat_numpy(state["params"])
    assert set(want) == set(t["straight_params"])
    err = max(float(np.max(np.abs(t["straight_params"][p] - want[p])))
              for p in want)
    assert err < TOL_PARAMS, err


def test_trainer_saves_the_image_one_device_would(ranks_4, tmp_path):
    """The mesh Trainer's step-2 image holds what one device's Trainer
    holds after the same 2 steps: every leaf of the state (params, m, v)
    within the step's params bound and the same step and pipeline state.
    Its format is one device's: a single-device save of the restored
    state under a root of the same name gives the same bytes and the
    same swarm metainfo."""
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.training.train_state import train_state_specs
    src = CheckpointStore(ranks_4[0]["trainer"]["store"])
    cfg = model_cfg(*TRAINER[:2])
    tree, extra = src.restore(train_state_specs(cfg), 2, device="cpu")
    _, state = one_device_trainer(2, str(tmp_path / "one"))
    got, want = _flat_numpy(tree), _flat_numpy(state)
    assert set(got) == set(want)
    err = max((float(np.max(np.abs(got[p] - want[p]))), p) for p in want)
    assert err[0] < TOL_PARAMS, err
    one = CheckpointStore(str(tmp_path / "one"))
    assert extra == one.restore(train_state_specs(cfg), 2, device="cpu")[1]
    dst = CheckpointStore(str(tmp_path / "ckpt"))
    dst.save(2, tree, extra=extra)
    assert dst.pack_image(2) == src.pack_image(2)
    with open(os.path.join(src.step_dir(2), "swarm.json")) as f, \
            open(os.path.join(dst.step_dir(2), "swarm.json")) as g:
        assert f.read() == g.read()


def test_launch_train_mesh_needs_a_process_group(monkeypatch):
    """`launch/train.py --mesh` without a process group to join raises;
    it never falls back to one device."""
    from repro_torch.launch.train import main
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="needs a process group"):
        main(["--arch", "zamba2-7b", "--reduced", "--device", "cpu",
              "--mesh", "host", "--steps", "1"])
