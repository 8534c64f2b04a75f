"""remat "dots" (`models/model.py` `_DotsPolicy`): each repeat under
activation checkpointing that saves the outputs of the products with no
batch dimensions and recomputes the rest, the reference's
`jax.checkpoint_policies.dots_with_no_batch_dims_saveable`.

Held on the CPU, f32, with the kernels' plain versions on and off
(``use_pallas``):
- the dots step's loss and every gradient leaf equal the port's "full"
  step bit for bit (the same kernels on the same inputs), and lie within
  1e-4 (loss, relative) and 1e-3 (each leaf, relative L2) of the
  reference's own dots step, in every family: attention (the tiny
  granite), zamba2 (SSD and the shared attention), qwen3-moe and
  seamless (encoder and decoder groups);
- the products it saves are the reference's: for one attention layer and
  one SSD layer, the shapes of the saved matmul outputs equal those of
  the reference's `dot_general`s with no batch dimensions, and contain
  the dot residuals of the reference's `saved_residuals`;
- no projection is recomputed: the backward's recompute dispatches no
  matmul of an unbatched product (counted under a dispatch mode);
- a (2, 2) gloo step under dots equals the "full" one.
"""
import collections
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax._src.ad_checkpoint import saved_residuals  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils.checkpoint import CheckpointPolicy  # noqa: E402

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.base import reduced_config as jax_reduced  # noqa: E402
from repro.models import model as JM  # noqa: E402

from repro_torch.configs.base import (GroupSpec, get_config,  # noqa: E402
                                      reduced_config)
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.parallel.sharding import (init_params_numpy,  # noqa: E402
                                           tree_leaves_with_path)
from repro_torch.training.train_state import loss_and_grads  # noqa: E402

from test_torch_mesh_serve import run_ranks  # noqa: E402

ARCHS = ("granite-8b", "zamba2-7b", "qwen3-moe-30b-a3b",
         "seamless-m4t-medium")
TOL_LOSS, TOL_LEAF = 1e-4, 1e-3
B, S, S_SRC = 2, 16, 24
# the tiny granite of `tests/test_trainer.py:18`
GRANITE = dict(vocab_size=64, d_model=32, num_heads=4, num_kv_heads=2,
               head_dim=8, d_ff=64)
MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
           torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)


def cfgs(arch, **kw):
    kw = dict(dtype="float32", remat="dots", **kw)
    if arch == "granite-8b":
        kw.update(GRANITE)
    return (jax_reduced(jax_get_config(arch)).replace(**kw),
            reduced_config(get_config(arch)).replace(**kw))


def inputs(cfg, seed=3):
    """numpy weights and batch.  Attention's q/k/v/o are scaled to their
    true fan-in, as `chip_smoke.py` scales them: under the reference's
    init rule (a rank-3 weight's head count as its fan-in) the random
    zamba2 and seamless are chaotic, and f32 rounding alone moves their
    gradients by more than the bound."""
    tree = init_params_numpy(seed, M.model_param_specs(cfg))
    for path, a in tree_leaves_with_path(tree):
        name = path.rsplit(".", 1)[-1]
        if a.ndim >= 3 and name in ("wq", "wk", "wv"):
            a *= np.float32((a.shape[-2] / a.shape[-3]) ** 0.5)
        elif a.ndim >= 3 and name == "wo" and "attn" in path:
            a *= np.float32((1.0 / a.shape[-3]) ** 0.5)
    rs = np.random.default_rng(seed)
    toks = rs.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.is_encdec:
        batch["enc_embeds"] = (rs.standard_normal((B, S_SRC, cfg.d_model))
                               * 0.1).astype(np.float32)
    return tree, batch


def tensors(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def reference_dots(arch):
    """The reference's loss and gradients under its own remat "dots"."""
    jcfg, cfg = cfgs(arch)
    tree, batch = inputs(cfg)
    f = jax.jit(jax.value_and_grad(lambda p, b: JM.loss_fn(jcfg, p, b),
                                   has_aux=True))
    (loss, _), grads = f(jax.tree_util.tree_map(jnp.asarray, tree),
                         {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), dict(tree_leaves_with_path(jax.device_get(grads)))


def rel_l2(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(ref - got.double().numpy())
                 / max(np.linalg.norm(ref), 1e-30))


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_dots_step_equals_full_and_the_reference(arch, use_pallas):
    _, cfg = cfgs(arch)
    if use_pallas:
        cfg = cfg.replace(use_pallas=True, attn_impl="flash")
    tree, batch = inputs(cfg)
    params = params_from_reference(tree, device="cpu")
    met, grads = loss_and_grads(cfg, params, tensors(batch))
    met_full, grads_full = loss_and_grads(cfg.replace(remat="full"), params,
                                          tensors(batch))
    assert torch.equal(met["loss"], met_full["loss"])
    got = dict(tree_leaves_with_path(grads))
    full = dict(tree_leaves_with_path(grads_full))
    assert got.keys() == full.keys()
    for path, g in got.items():
        assert torch.equal(g, full[path]), path
    loss, want = reference_dots(arch)
    assert abs(float(met["loss"]) - loss) <= TOL_LOSS * abs(loss)
    assert want.keys() == got.keys()
    worst = max((rel_l2(a, got[p]), p) for p, a in want.items())
    assert worst[0] <= TOL_LEAF, worst


# ----------------------- what the policy saves ----------------------------- #
class RecordingDots(M._DotsPolicy):
    """The port's policy, recording the shape of each unbatched product
    and the size of each matmul output it saves."""
    seen = []

    def __init__(self):
        super().__init__()
        self.products, self.saved = [], []
        RecordingDots.seen.append(self)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = super().__torch_function__(func, types, args, kwargs)
        if M._no_batch_dims(func, args):
            self.products.append(tuple(out.shape))
        return out

    def policy(self, ctx, op, *args, **kwargs):
        decision = super().policy(ctx, op, *args, **kwargs)
        if decision == CheckpointPolicy.MUST_SAVE:
            self.saved.append(ctx.op_output.numel())
        return decision


def one_layer(arch, layer):
    """The config cut to one group of one repeat of ``layer``."""
    jcfg, cfg = cfgs(arch)
    ls = cfg.groups[0].layers[layer]
    jls = jcfg.groups[0].layers[layer]
    return (jcfg.replace(groups=(type(jcfg.groups[0])((jls,), 1),)), jls,
            cfg.replace(groups=(GroupSpec((ls,), 1),)))


def unbatched_dots(jaxpr):
    """Output shapes of the `dot_general`s with no batch dimensions, in
    ``jaxpr`` and every jaxpr nested in it."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            (_, _), (lb, rb) = eqn.params["dimension_numbers"]
            if not lb and not rb:
                out.append(tuple(eqn.outvars[0].aval.shape))
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                sub = getattr(sub, "jaxpr", sub)
                if hasattr(sub, "eqns"):
                    out += unbatched_dots(sub)
    return out


@pytest.mark.parametrize("arch,layer", [("granite-8b", 0),
                                        ("zamba2-7b", 0)])
def test_saved_products_are_the_references_dots(arch, layer, monkeypatch):
    """One repeat of an attention layer (with its dense MLP) and of an SSD
    layer.  The port saves one matmul output per unbatched product, and
    their shapes are those of the reference's `dot_general`s with no
    batch dimensions.  The reference's `saved_residuals` (those not from
    an argument or a constant) are these less the layer's last product,
    whose output feeds only the residual sum: its backward reads the
    product's inputs, not its output, so JAX keeps it nowhere, while a
    selective checkpoint keeps every output its policy saves (one
    (B, S, d) tensor a layer)."""
    jcfg, jls, cfg = one_layer(arch, layer)
    tree, batch = inputs(cfg)
    monkeypatch.setattr(M, "_DotsPolicy", RecordingDots)
    RecordingDots.seen.clear()
    params = params_from_reference(tree, device="cpu")
    for _, p in tree_leaves_with_path(params):
        p.requires_grad_(True)
    M.loss_fn(cfg, params, tensors(batch))
    (rec,) = RecordingDots.seen
    assert rec.saved == [int(np.prod(s)) for s in rec.products]

    lp = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]),
                                tree["decoder"]["g0"]["L0"])
    sp = jax.tree_util.tree_map(jnp.asarray, tree.get("shared_attn"))
    x = jnp.asarray(np.random.default_rng(0).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32))
    pos = jnp.broadcast_to(jnp.arange(S), (B, S))

    def layer_fn(lp, x, sp):
        y, aux, _ = JM.apply_layer(jcfg, jls, lp, x, jnp.zeros(()),
                                   shared_params=sp, mode="train",
                                   positions=pos)
        return y, aux
    dots = unbatched_dots(jax.make_jaxpr(layer_fn)(lp, x, sp).jaxpr)
    assert sorted(rec.products) == sorted(dots)
    residuals = collections.Counter(
        tuple(aval.shape) for aval, src in saved_residuals(
            jax.checkpoint(layer_fn, policy=jax.checkpoint_policies
                           .dots_with_no_batch_dims_saveable), lp, x, sp)
        if not src.startswith(("from the argument", "from a constant")))
    assert collections.Counter(rec.products) - residuals == \
        collections.Counter({(B, S, cfg.d_model): 1})
    assert not residuals - collections.Counter(rec.products)


class CountRecompute(TorchDispatchMode):
    """The batch size of each matmul launch dispatched inside a
    ``remat_recompute`` profiler range (what a saved output does not
    reach), 0 for a 2-d product.  An unbatched einsum launches a `bmm`
    with a batch of 1; at B = 2 every batched product here has more.
    The port opens its ranges only while a profiler records: use inside
    a `torch.profiler.profile`."""

    def __init__(self):
        super().__init__()
        self.ranges, self.batches = [], []       # the open ranges' names

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.profiler._record_function_enter_new.default:
            self.ranges.append(args[0])
        elif func is torch.ops.profiler._record_function_exit._RecordFunction:
            self.ranges.pop()
        elif "remat_recompute" in self.ranges and func in MATMULS:
            self.batches.append(out.shape[0] if out.ndim == 3 else 0)
        return out


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("arch", ["granite-8b", "zamba2-7b",
                                  "qwen3-moe-30b-a3b"])
def test_no_projection_is_recomputed(arch, use_pallas):
    """Every matmul that the dots recompute launches is a batched product
    (scores, the experts), with the kernels' plain versions on and off;
    "full" recomputes the projections besides."""
    _, cfg = cfgs(arch)
    if use_pallas:
        cfg = cfg.replace(use_pallas=True, attn_impl="flash")
    tree, batch = inputs(cfg)
    params = params_from_reference(tree, device="cpu")
    seen = {}
    for remat in ("dots", "full"):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]), \
                CountRecompute() as mode:
            loss_and_grads(cfg.replace(remat=remat), params, tensors(batch))
        seen[remat] = mode.batches
    assert all(b > 1 for b in seen["dots"]), seen["dots"]
    assert sorted(b for b in seen["full"] if b > 1) == sorted(seen["dots"])
    assert any(b <= 1 for b in seen["full"])


# ------------------------------ on a mesh --------------------------------- #
MESH_CASES = {"zamba2": ("zamba2-7b", {}),
              "qwen3_14b_tp_sp": ("qwen3-14b", dict(
                  d_model=64, num_heads=6, num_kv_heads=2, head_dim=16,
                  vocab_size=256, tp_sp=True, pad_attn_heads=True)),
              "moe": ("qwen3-moe-30b-a3b", {})}


def _mesh_rank(rank):
    """Each case's loss and gradients on (2, 2) under "full" and "dots",
    from the same numpy weights and batch."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.convert import shard_params
    from repro_torch.parallel.sharding import DEFAULT_RULES
    mesh = make_host_mesh(2, 2)
    out = {}
    for name, (arch, kw) in MESH_CASES.items():
        cfg = reduced_config(get_config(arch)).replace(dtype="float32",
                                                       **kw)
        specs = M.model_param_specs(cfg)
        tree, batch = inputs(cfg)
        params = shard_params(tree, specs, mesh, DEFAULT_RULES,
                              device="cpu")
        for remat in ("full", "dots"):
            met, grads = loss_and_grads(cfg.replace(remat=remat), params,
                                        tensors(batch), mesh)
            out[name, remat] = (float(met["loss"]), {
                p: g.numpy() for p, g in tree_leaves_with_path(grads)})
    return out


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    return run_ranks(_mesh_rank, 4, tmp_path_factory.mktemp("dots"),
                     limit=240.0)


@pytest.mark.parametrize("name", sorted(MESH_CASES))
def test_mesh_dots_step_equals_full(mesh_runs, name):
    for out in mesh_runs:
        loss, grads = out[name, "dots"]
        loss_full, grads_full = out[name, "full"]
        assert loss == loss_full
        assert grads.keys() == grads_full.keys()
        for path, g in grads.items():
            np.testing.assert_array_equal(g, grads_full[path], err_msg=path)
