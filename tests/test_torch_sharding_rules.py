"""The port's sharding rules against the reference's `PartitionSpec`s.

`repro_torch.parallel.sharding.logical_to_mesh_axes` and `param_sharding`
must give, for every leaf of every registered config's parameter, cache
and train-state spec tree, the spec that `repro.parallel.sharding` gives
on the same mesh, under both rule sets (training's `DEFAULT_RULES` and
the inference rules of `infer_rules`: TP-only, or FSDP over ``data`` for
a MoE model).  The reference's meshes are `jax.sharding.AbstractMesh`es
(no devices); the port's are name -> size mappings.  Pure and fast.
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.base import list_archs  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.parallel import sharding as JS  # noqa: E402
from repro.training import train_state as JT  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.parallel import sharding as S  # noqa: E402
from repro_torch.training import train_state as T  # noqa: E402

MESHES = [((2, 4), ("data", "model")), ((1, 8), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
ARCHS = list_archs()


def trees(cfg, mod, specs_of_train):
    """(name, spec tree) of a config: params, caches, train state."""
    return [("params", mod.model_param_specs(cfg)),
            ("caches", mod.cache_specs_tree(cfg, 8, 4096, src_len=1024)),
            ("train", specs_of_train(cfg))]


def leaves(tree):
    return list(S.tree_leaves_with_path(tree, sep="/"))


def jleaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=JS.is_spec)[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): s
            for path, s in flat}


def rule_sets(jcfg, cfg):
    return [("default", JS.DEFAULT_RULES, S.DEFAULT_RULES),
            ("infer", JS.infer_rules(jcfg), S.infer_rules(cfg))]


def test_rule_tables_equal_the_reference():
    for jr, r in ((JS.DEFAULT_RULES, S.DEFAULT_RULES),
                  (JS.INFERENCE_RULES, S.INFERENCE_RULES)):
        assert {k: tuple(v) for k, v in jr.rules.items()} == r.rules
        assert tuple(jr.fsdp_axes) == r.fsdp_axes
    for arch in ARCHS:
        jr, r = JS.infer_rules(jax_get_config(arch)), S.infer_rules(
            get_config(arch))
        assert tuple(jr.fsdp_axes) == r.fsdp_axes, arch


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_the_reference_on_every_leaf(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    ours = trees(cfg, M, T.train_state_specs)
    theirs = trees(jcfg, JM, JT.train_state_specs)
    n = 0
    for (name, tree), (_, jtree) in zip(ours, theirs):
        jl = jleaves(jtree)
        tl = dict(leaves(tree))
        assert sorted(tl) == sorted(jl), name
        for shape, names in MESHES:
            jmesh = AbstractMesh(shape, names)
            mesh = dict(zip(names, shape))
            for rname, jrules, rules in rule_sets(jcfg, cfg):
                for path, s in tl.items():
                    js = jl[path]
                    assert (tuple(s.shape), s.logical, s.fsdp_dim) == (
                        tuple(js.shape), tuple(js.logical), js.fsdp_dim), path
                    want = tuple(JS.logical_to_mesh_axes(
                        jmesh, js.shape, js.logical, jrules))
                    got = S.logical_to_mesh_axes(mesh, s.shape, s.logical,
                                                 rules)
                    assert got == want, (name, path, shape, rname)
                    want = tuple(JS.param_sharding(jmesh, js, jrules).spec)
                    got = S.param_sharding(mesh, s, rules)
                    assert got == want, (name, path, shape, rname)
                    n += 1
    assert n > 100


def test_embedding_opts_out_of_fsdp():
    """`fsdp_dim=-2` on the embedding: under the MoE inference rules its
    d_model dim stays whole, while the untied LM head takes FSDP."""
    cfg = get_config("qwen3-moe-30b-a3b")
    specs = M.model_param_specs(cfg)["embed"]
    rules = S.infer_rules(cfg)
    mesh = {"data": 2, "model": 4}
    assert specs["embedding"].fsdp_dim == -2
    assert S.param_sharding(mesh, specs["embedding"], rules) == ("model",
                                                                   None)
    assert S.param_sharding(mesh, specs["lm_head"], rules) == ("data",
                                                                 "model")


def test_local_shapes_and_abstract_specs():
    cfg = get_config("zamba2-7b")
    specs = M.model_param_specs(cfg)
    mesh = {"data": 2, "model": 4}
    rules = S.infer_rules(cfg)
    wz = specs["decoder"]["g0"]["L0"]["ssd"]["wz"]
    spec = S.param_sharding(mesh, wz, rules)
    assert S.local_shape(wz.shape, spec, mesh) == (wz.shape[0], wz.shape[1],
                                                   wz.shape[2] // 4)
    meta = S.specs_to_abstract(specs)
    assert meta["decoder"]["g0"]["L0"]["ssd"]["wz"].shape == wz.shape
    assert meta["decoder"]["g0"]["L0"]["ssd"]["wz"].device.type == "meta"
    meta = S.specs_to_abstract(specs, mesh, rules,
                               dtype_override=torch.bfloat16)
    flat = dict(S.tree_leaves_with_path(specs))
    shard = dict(S.tree_leaves_with_path(
        S.specs_to_shardings(specs, mesh, rules)))
    for path, t in S.tree_leaves_with_path(meta):
        s, lay = flat[path], shard[path]
        assert lay == S.param_sharding(mesh, s, rules)
        assert tuple(t.shape) == S.local_shape(s.shape, lay, mesh)
        assert t.dtype == torch.bfloat16


def test_train_step_and_int8_backward_refuse_a_mesh_until_their_slice():
    """Their slice has landed: the train step takes a mesh (its leaves'
    block axes from `param_sharding`), and the int8 all-to-all passes
    its gradient straight through (a model axis of one rank: no
    process group)."""
    from repro_torch.configs.base import reduced_config
    from repro_torch.models.moe import a2a_int8
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training.train_state import _leaf_axes, make_train_step
    cfg = reduced_config(get_config("zamba2-7b"))
    mesh = {"data": 2, "model": 2}
    assert callable(make_train_step(cfg, AdamWConfig(), mesh=mesh))
    axes = _leaf_axes(cfg, mesh, S.DEFAULT_RULES)
    assert axes["decoder.g0.L0.ssd.wz"] == ("data", "model")
    assert axes["embed.embedding"] == ("model",)
    x = torch.ones((4, 2, 8), requires_grad=True)
    a2a_int8(x * 3.0, "model", {"model": 1}, 0, 1).sum().backward()
    assert torch.equal(x.grad, torch.full_like(x, 3.0))
