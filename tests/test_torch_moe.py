"""The port's mixture-of-experts layer (`repro_torch.models.moe`) against
the reference package's (`repro.models.moe`) on the CPU, with inputs drawn
by numpy and handed to both.

Tolerances, all f32: routing (expert ids, the dispatch plan's keep and
destination rows, capacity drops) equal; gates and the aux loss within
1e-6; layer outputs within 1e-5 of their largest magnitude (the combine
adds a token's k expert outputs in routing order, the reference in expert
order); the reduced models' loss and every gradient leaf within 1e-5
relative to the leaf's largest magnitude, the bar of
`tests/test_torch_training.py`, or, where that is larger, within 3x the
reference's own distance to its gradient from the parameters moved one ulp
up and down (the bar of `tests/test_torch_train_steps.py`: the reference's
init rule saturates the attention softmax, and llama4's attention `wk`
gradient moves 3.2e-5 under that nudge in the reference itself).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.base import reduced_config as jax_reduced  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402

from repro_torch.configs.base import get_config, reduced_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.parallel.sharding import (ParamSpec,  # noqa: E402
                                           init_params_numpy,
                                           tree_leaves_with_path)
from repro_torch.training.train_state import loss_and_grads  # noqa: E402

REL = 1e-5


def rel_err(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    got = got.detach().double().numpy()
    return float(np.max(np.abs(ref - got))) / max(
        float(np.max(np.abs(ref))), 1e-30)


def t(a):
    return torch.from_numpy(np.array(a))


def cfgs(arch, **kw):
    kw = dict(dtype="float32", **kw)
    return (jax_reduced(jax_get_config(arch)).replace(**kw),
            reduced_config(get_config(arch)).replace(**kw))


def routing_inputs(N=96, d=32, E=8, seed=0):
    rs = np.random.default_rng(seed)
    return (rs.standard_normal((N, d)).astype(np.float32),
            (rs.standard_normal((d, E)) / math.sqrt(d)).astype(np.float32))


def reference_plan(experts, capacity, e_count):
    """keep and dest of the reference's `_dispatch_compute`
    (`src/repro/models/moe.py:117-134`, its first lines copied, jnp),
    taken back from sorted order to routing order."""
    e_flat = jnp.asarray(experts).reshape(-1)
    order = jnp.argsort(e_flat, stable=True)
    e_s = e_flat[order]
    counts = jnp.bincount(e_s, length=e_count + 1)
    starts = jnp.cumsum(counts) - counts
    pos = jnp.arange(e_flat.shape[0], dtype=jnp.int32) - starts[e_s].astype(
        jnp.int32)
    keep = (pos < capacity) & (e_s < e_count)
    dest = jnp.where(keep, e_s * capacity + pos, e_count * capacity)
    order = np.asarray(order)
    keep_u, dest_u = np.empty(len(order), bool), np.empty(len(order), np.int64)
    keep_u[order], dest_u[order] = np.asarray(keep), np.asarray(dest)
    return keep_u, dest_u


@pytest.mark.parametrize("k", [1, 2, 4])
def test_route_matches_reference(k):
    xf, w = routing_inputs(seed=k)
    jg, je, jp = jmoe._route(jnp.asarray(xf), jnp.asarray(w), k)
    g, e, p = moe._route(t(xf), t(w), k)
    assert np.array_equal(np.asarray(je), e.numpy())
    assert float(np.max(np.abs(np.asarray(jg) - g.numpy()))) < 1e-6
    assert float(np.max(np.abs(np.asarray(jp) - p.numpy()))) < 1e-6


def test_route_breaks_ties_toward_the_lower_expert():
    """Equal probabilities (a zero router): `lax.top_k` takes the lowest
    expert ids first; so does the port's stable sort."""
    xf = np.ones((5, 4), np.float32)
    w = np.zeros((4, 6), np.float32)
    _, je, _ = jmoe._route(jnp.asarray(xf), jnp.asarray(w), 3)
    _, e, _ = moe._route(t(xf), t(w), 3)
    assert np.array_equal(np.asarray(je), e.numpy())
    assert e.tolist() == [[0, 1, 2]] * 5


@pytest.mark.parametrize("k", [1, 2])
def test_aux_loss_matches_reference(k):
    xf, w = routing_inputs(seed=10 + k)
    _, je, jp = jmoe._route(jnp.asarray(xf), jnp.asarray(w), k)
    ref = jmoe._aux_loss(jp, je, w.shape[1])
    _, e, p = moe._route(t(xf), t(w), k)
    assert abs(float(ref) - float(moe._aux_loss(p, e, w.shape[1]))) < 1e-6


@pytest.mark.parametrize("capacity", [96 * 2, 20, 7])
def test_dispatch_compute_matches_reference(capacity):
    """Dropless (capacity = N k), and two capacities that drop
    assignments: the same keep / dest plan, the same output."""
    N, d, E, dff, k = 96, 32, 8, 24, 2
    xf, w = routing_inputs(N, d, E, seed=3)
    rs = np.random.default_rng(4)
    wi_g, wi_u = (rs.standard_normal((E, d, dff)).astype(np.float32)
                  / math.sqrt(d) for _ in range(2))
    wo = rs.standard_normal((E, dff, d)).astype(np.float32) / math.sqrt(dff)
    jg, je, _ = jmoe._route(jnp.asarray(xf), jnp.asarray(w), k)
    ref = jmoe._dispatch_compute(jnp.asarray(xf), jg, je, None,
                                 jnp.asarray(wi_g), jnp.asarray(wi_u),
                                 jnp.asarray(wo), capacity, 0, E)
    g, e, _ = moe._route(t(xf), t(w), k)
    keep, dest = moe._dispatch_plan(e, capacity, 0, E)
    want_keep, want_dest = reference_plan(np.asarray(je), capacity, E)
    assert np.array_equal(keep.numpy(), want_keep)
    assert np.array_equal(dest.numpy(), want_dest)
    assert bool(keep.all()) == (capacity >= N * k)
    out = moe._dispatch_compute(t(xf), g, e, None, t(wi_g), t(wi_u), t(wo),
                                capacity, 0, E)
    assert rel_err(ref, out) < REL


def test_dispatch_plan_of_a_slice_of_experts_with_keepers():
    """The replicated mesh mode's call shape on one device: experts
    outside [e_base, e_base + e_count) and masked assignments go to the
    trash row."""
    rs = np.random.default_rng(5)
    experts = t(rs.integers(0, 8, (40, 2)))
    keepers = t(rs.random((40, 2)) > 0.3)
    keep, dest = moe._dispatch_plan(experts, 6, 4, 4, keepers)
    flat, kp = experts.reshape(-1), keepers.reshape(-1)
    local = (flat >= 4) & kp
    assert not bool((keep & ~local).any())
    assert bool((dest[~keep] == 4 * 6).all())
    for e in range(4):
        rows = dest[keep & (flat == 4 + e)]
        assert rows.tolist() == list(range(e * 6, e * 6 + len(rows)))


# capacity factor 1.0: the capacity rule's slots (N k / E) fall short of
# the busiest experts' counts
DROPPING = {"capacity_factor": 1.0}


@pytest.mark.parametrize("arch,B,S", [("qwen3-moe-30b-a3b", 2, 16),
                                      ("qwen3-moe-30b-a3b", 4, 160),
                                      ("llama4-scout-17b-a16e", 2, 16)])
def test_moe_block_matches_reference(arch, B, S):
    """The single-device `moe_block` of the reduced configs (llama4: top-1
    and the shared expert); B*S = 640 > 512 takes the capacity rule and
    drops assignments."""
    jcfg, cfg = cfgs(arch, **DROPPING)
    specs = moe.moe_specs(cfg)
    tree = init_params_numpy(6, specs)
    x = np.random.default_rng(7).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    jout, jaux = jax.jit(lambda p, x: jmoe.moe_block(p, x, jcfg))(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x))
    out, aux = moe.moe_block(params_from_reference(tree, specs,
                                                   device="cpu"), t(x), cfg)
    assert rel_err(jout, out) < REL
    assert abs(float(jaux) - float(aux)) < 1e-6 * max(1.0, abs(float(jaux)))
    N = B * S
    cap = moe.capacity(cfg, N)
    assert cap == (N if N <= 512 else math.ceil(
        N * cfg.experts_per_token / cfg.num_experts * cfg.capacity_factor))
    _, e, _ = moe._route(t(x).reshape(N, -1), t(tree["router"]),
                         cfg.experts_per_token)
    keep, _ = moe._dispatch_plan(e, cap, 0, cfg.num_experts)
    assert bool(keep.all()) == (N <= 512)


def test_llama4_forward_on_embeds_matches_reference():
    """llama4's early-fusion input: precomputed embeddings, no tokens."""
    jcfg, cfg = cfgs("llama4-scout-17b-a16e")
    tree = init_params_numpy(8, M.model_param_specs(cfg))
    emb = (np.random.default_rng(9).standard_normal((2, 12, cfg.d_model))
           * 0.1).astype(np.float32)
    jl, jaux, _ = JM.forward(jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
                             {"embeds": jnp.asarray(emb)}, mode="train")
    with torch.no_grad():
        tl, aux, _ = M.forward(cfg, params_from_reference(
            tree, M.model_param_specs(cfg), device="cpu"),
            {"embeds": t(emb)}, mode="train")
    assert rel_err(jl, tl) < 1e-4
    assert abs(float(jaux) - float(aux)) < 1e-6


@pytest.mark.parametrize("arch,S", [("qwen3-moe-30b-a3b", 32),
                                    ("qwen3-moe-30b-a3b", 160),
                                    ("llama4-scout-17b-a16e", 32)])
def test_loss_and_grads_match_reference(arch, S):
    """The whole reduced model's loss (NLL + router aux) and the gradient
    of every leaf, router included, against `jax.grad` of the reference's
    `loss_fn`; S=160 (B=4: N = 640) drops assignments."""
    jcfg, cfg = cfgs(arch, **DROPPING)
    specs = M.model_param_specs(cfg)
    tree = init_params_numpy(10, specs)
    toks = np.random.default_rng(11).integers(
        0, cfg.vocab_size, (4, S + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(jcfg, p, b), has_aux=True))
    (jloss, jmet), jg = grad_fn(jax.tree_util.tree_map(jnp.asarray, tree), jb)
    near = []
    for d in (1, -1):
        moved = jax.tree_util.tree_map(lambda a: jnp.asarray(np.nextafter(
            a, np.float32(d * np.inf)).astype(np.float32)), tree)
        near.append(dict(tree_leaves_with_path(jax.device_get(
            grad_fn(moved, jb)[1]))))
    kept = []
    plan = moe._dispatch_plan

    def record(*args, **kw):
        keep, dest = plan(*args, **kw)
        kept.append(keep)
        return keep, dest
    moe._dispatch_plan = record
    try:
        met, grads = loss_and_grads(
            cfg, params_from_reference(tree, specs, device="cpu"),
            {k: t(v) for k, v in b.items()})
    finally:
        moe._dispatch_plan = plan
    assert all(bool(k.all()) == (4 * S <= 512) for k in kept)
    assert rel_err(jloss, met["loss"]) < REL
    assert abs(float(jmet["aux"]) - float(met["aux"])) < \
        1e-6 * max(1.0, abs(float(jmet["aux"])))
    got = dict(tree_leaves_with_path(grads))
    want = dict(tree_leaves_with_path(jax.device_get(jg)))
    assert got.keys() == want.keys()
    assert any("router" in p for p in got)
    for path, a in want.items():
        floor = max(rel_err(a, t(n[path])) for n in near)
        assert rel_err(a, got[path]) <= max(REL, 3.0 * floor), (path, floor)


def test_large_leaf_fills_slice_by_slice(monkeypatch):
    """A leaf above `DRAW_ELEMENTS` is drawn along its leading axis in the
    target dtype, no f32 copy of the whole: the right shape, dtype and
    spread, and slices that differ."""
    monkeypatch.setattr(sharding, "DRAW_ELEMENTS", 1000)
    s = ParamSpec((5, 30, 40), (None, None, None))
    gen = torch.Generator().manual_seed(0)
    w = sharding.init_param(gen, s, dtype=torch.bfloat16, device="cpu")
    assert w.shape == (5, 30, 40) and w.dtype == torch.bfloat16
    assert abs(float(w.float().std()) * math.sqrt(30) - 1.0) < 0.05
    assert not torch.equal(w[0], w[1])
    small = sharding.init_param(torch.Generator().manual_seed(0),
                                ParamSpec((2, 3), (None, None)),
                                device="cpu")
    want = torch.randn((2, 3), generator=torch.Generator().manual_seed(0))
    assert torch.equal(small, want * (1.0 / math.sqrt(2)))


@pytest.mark.parametrize("shape", [(0, 8, 4), (3, 0, 4), (4,)])
def test_init_param_takes_empty_and_rank_one_leaves(shape):
    """The slice loop's rows per slice never divide by a zero-size axis,
    and a vector is drawn like any leaf."""
    s = ParamSpec(shape, (None,) * len(shape))
    w = sharding.init_param(torch.Generator().manual_seed(0), s,
                            device="cpu")
    assert w.shape == shape and bool(torch.isfinite(w).all())
    want = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    assert torch.equal(w, want * sharding._std(s))


def test_serve_launcher_runs_a_reduced_moe(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "qwen3-moe-30b-a3b", "--reduced", "--requests",
                "3", "--max-new", "3", "--slots", "2", "--device", "cpu"])
    assert "served 3 requests, 9 tokens" in capsys.readouterr().out
