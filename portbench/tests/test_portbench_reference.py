"""The plain reference of `portbench/reference` against the program's
plain torch paths, in float32 at reduced widths, layer by layer: what a
layer adds to the residual, the states it leaves in the cache, the
routing, the head.  The reference itself imports nothing of the
program, which the last test checks."""
import ast
import subprocess
import sys

import pytest
import torch

from portbench_small import ROOT, small_run_as, one_thread  # noqa: F401
from portbench import check, harness, weights
from portbench.reference import ops


def rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def setup(config, B, S, seed=5):
    from repro_torch.models import model as M
    m = dict(small_run_as(config), dtype="float32")
    cfg = harness.program_config({"run_as": m}, "cpu")
    params = weights.draw(seed, M.model_param_specs(cfg), torch.float32,
                          "cpu")
    return m, cfg, params


@pytest.mark.parametrize("config,B,S", [("zamba2-7b", 2, 40),
                                        ("qwen3-moe-30b-a3b", 2, 320)])
def test_layers_match_the_program(config, B, S):
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import init_params
    torch.manual_seed(0)
    m, cfg, params = setup(config, B, S)
    x = torch.randn(B, S, m["d_model"])
    pos = torch.broadcast_to(torch.arange(S), (B, S))
    seen = set()
    for at in check.places(m):
        ls = at.spec
        key = (ls["mixer"], ls["mlp"], ls["shared_attn"])
        if key in seen:
            continue
        seen.add(key)
        spec = cfg.groups[at.group].layers[at.position]
        cache = init_params(0, M.layer_cache_specs(cfg, spec, B, S),
                            device="cpu")
        p = ops.layer_leaves(params, at)
        got, _, nc = M.apply_layer(cfg, spec, p, x, torch.zeros(()),
                                   shared_params=params.get("shared_attn"),
                                   mode="prefill", positions=pos,
                                   cache=cache)
        want, st = ops.layer(at, params, x, x, m, "f32")
        assert rel(got - x, want - x) < 1e-4, key
        for name, w in st.items():
            if name in check.STATE_NUMBER:
                assert rel(cache[name], w) < 1e-4, (key, name)
        if ls["mlp"] == "moe":
            # above 512 tokens the capacity drops assignments
            assert ops.moe_capacity(B * S, m) < B * S
    assert len(seen) == (2 if config == "zamba2-7b" else 1)


@pytest.mark.parametrize("config", ["zamba2-7b", "qwen3-moe-30b-a3b"])
def test_embedding_and_head_match_the_program(config):
    from repro_torch.models import layers as L
    m, cfg, params = setup(config, 2, 8)
    tok = torch.randint(0, m["vocab_size"], (2, 8))
    assert torch.equal(L.embed_tokens(params["embed"], tok, cfg),
                       ops.embed(params, tok))
    x = torch.randn(2, 1, m["d_model"])
    got = L.lm_logits(params["embed"], x, cfg)[:, 0]
    assert rel(got, ops.logits(params, x[:, 0], m, "f32")) < 1e-5


def test_routing_matches_the_program():
    from repro_torch.models import moe as moe_lib
    torch.manual_seed(1)
    x = torch.randn(640, 64).bfloat16()
    w = torch.randn(64, 8)
    gates, experts, _ = moe_lib._route(x, w, 2)
    g, e = ops.moe_route(x, w, 2)
    assert torch.equal(e, experts) and torch.equal(g, gates)


def test_scan_matches_the_quadratic_form():
    from repro_torch.kernels.ssd.ref import ssd_naive
    torch.manual_seed(2)
    B, S, H, P, G, N = 2, 50, 4, 8, 2, 8
    x = torch.randn(B, S, H, P)
    dt = torch.nn.functional.softplus(torch.randn(B, S, H))
    A = -torch.exp(torch.randn(H) * 0.3)
    Bm, Cm = torch.randn(B, S, G, N), torch.randn(B, S, G, N)
    y, st = ops.ssd_scan(x, dt, A, Bm, Cm, 16, "f32")
    wy, wst = ssd_naive(x, dt, A, Bm, Cm)
    assert rel(y, wy) < 1e-5 and rel(st, wst) < 1e-5


PROGRAM = {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_reference_imports_nothing_of_the_program():
    """Every module of `portbench/reference`, by its source and by what
    importing it loads."""
    modules = sorted((ROOT / "portbench" / "reference").glob("*.py"))
    assert {"ops", "train"} <= {p.stem for p in modules}
    for path in modules:
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree)
                 if isinstance(n, ast.Import) for a in n.names]
        names += [n.module or "" for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom)]
        assert not {n.split(".")[0] for n in names} & PROGRAM, path
    code = ("import sys; sys.path.insert(0, %r); %s; "
            "print(sorted({n.split('.')[0] for n in sys.modules} & %r))"
            % (str(ROOT), "; ".join(f"import portbench.reference.{p.stem}"
                                    for p in modules), PROGRAM))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stderr
