"""The published Zamba2 block in the port (`configs/zamba2_7b_instruct.py`)
against the benchmark's plain reference of it (`portbench/reference/
zamba2.py`), on the CPU in float32 at a tiny size: two shared blocks each
applied twice, two B/C groups, every leaf drawn nonzero (norm offsets,
conv biases, A_log, D and dt_bias too).  Prefill logits and caches,
prefill then decode through the cache against the reference's full
forward, one train step's loss and gradients, and each block's gradient
as the sum of its applications'."""
import math
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.check import places  # noqa: E402
from portbench.reference import zamba2 as ref  # noqa: E402
from repro_torch.configs.base import GroupSpec, LayerSpec, get_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.parallel.sharding import (init_params,  # noqa: E402
                                           tree_leaves_with_path)

SSD = LayerSpec(mixer="ssd", mlp="none")
HYB = LayerSpec(mixer="ssd", mlp="none", shared_attn=True)


def tiny(**kw):
    """zamba2-7b-instruct at a tiny size, its shape kept: 10 layers, the
    shared block applied 4 times (blocks 0, 1, 0, 1), GQA in the block,
    2 groups, float32 on the CPU."""
    return get_config("zamba2-7b-instruct").replace(
        d_model=32, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=48,
        vocab_size=128, shared_attn_heads=4, shared_attn_kv_heads=2,
        shared_adapter_rank=4, attn_scale=(16 / 2) ** -0.5, ssm_state=8,
        ssm_head_dim=8, ssd_chunk=8, dtype="float32",
        groups=(GroupSpec((SSD, HYB), 3), GroupSpec((SSD, SSD, HYB), 1),
                GroupSpec((SSD,), 1)), **{"remat": "none", **kw})


FIELDS = ("d_model", "vocab_size", "num_heads", "num_kv_heads", "head_dim",
          "rope_theta", "ssm_state", "ssm_expand", "ssm_head_dim",
          "ssm_ngroups", "ssm_conv_width", "ssd_chunk", "shared_attn_heads",
          "shared_attn_kv_heads", "shared_blocks", "shared_adapter_rank",
          "d_ff", "norm_eps", "tie_embeddings")


def run_as(cfg) -> dict:
    """The configuration as the benchmark's ``run_as`` gives it to the
    reference."""
    m = {k: getattr(cfg, k) for k in FIELDS}
    m["groups"] = [{"layers": [{"mixer": ls.mixer, "mlp": ls.mlp,
                                "shared_attn": ls.shared_attn}
                               for ls in g.layers], "repeat": g.repeat}
                   for g in cfg.groups]
    return m


def draw(cfg, seed=0) -> dict:
    """The program's initial tree with every leaf nonzero: the zero and
    one inits (norm offsets, A_log, D, dt_bias) moved by N(0, 0.2)."""
    specs = M.model_param_specs(cfg)
    params = init_params(seed, specs, device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    for path, s in tree_leaves_with_path(specs):
        node = params
        *heads, last = path.split(".")
        for h in heads:
            node = node[h]
        if s.init in ("zeros", "ones"):
            node[last] = node[last] + 0.2 * torch.randn(
                s.shape, generator=gen)
        assert bool((node[last] != 0).any()), path
    return params


def rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


# float32 rounding grows about twofold a layer through this random stack
# (the first layer's state agrees to 1e-8, the tenth's to 4e-5); a wrong
# scale, bias, group or block reads 1e-2 and more
TOL = 2e-4


def reference_forward(m, params, tokens):
    """Each layer's states and the last residual of the reference."""
    x0 = ref.embed(params, tokens)
    x, states = x0, []
    for at in places(m):
        x, st = ref.layer(at, params, x, x0, m, "f32")
        states.append(st)
    return x, states


def test_every_leaf_is_drawn_and_the_counts_agree():
    cfg = tiny()
    m = run_as(cfg)
    assert cfg.param_count() == ref.param_count(m)
    params = draw(cfg)
    assert params["shared_attn"]["attn"]["wq"].shape == (2, 64, 4, 16)
    assert "lm_head" not in params["embed"]       # tied


def test_prefill_logits_and_caches_match_the_reference():
    cfg = tiny()
    m, params = run_as(cfg), draw(cfg)
    B, S = 2, 20
    tok = torch.randint(0, cfg.vocab_size, (B, S),
                        generator=torch.Generator().manual_seed(5))
    caches = M.init_caches(cfg, B, S, device="cpu")
    with torch.no_grad():
        logits, caches = M.prefill(cfg, params, {"tokens": tok}, caches)
        x, states = reference_forward(m, params, tok)
        want = ref.logits(params, x[:, -1], m, "f32")
    assert rel(logits, want) < TOL
    seen = set()
    for at, st in zip(places(m), states):
        c = caches["decoder"][f"g{at.group}"][f"L{at.position}"]
        for name, w in st.items():
            assert rel(c[name][at.repeat], w) < TOL, (at.index, name)
            seen.add(name)
    assert seen == {"ssm", "conv_x", "conv_b", "conv_c", "shared_k",
                    "shared_v"}


def test_prefill_then_decode_matches_the_full_forward():
    cfg = tiny()
    m, params = run_as(cfg), draw(cfg)
    B, S, steps = 2, 13, 5
    tok = torch.randint(0, cfg.vocab_size, (B, S + steps),
                        generator=torch.Generator().manual_seed(6))
    caches = M.init_caches(cfg, B, S + steps, device="cpu")
    got = []
    with torch.no_grad():
        lg, caches = M.prefill(cfg, params, {"tokens": tok[:, :S]}, caches)
        got.append(lg)
        for i in range(steps - 1):
            lg, caches = M.decode_step(
                cfg, params, {"tokens": tok[:, S + i:S + i + 1]}, caches)
            got.append(lg)
        x, _ = reference_forward(m, params, tok)
        for i, lg in enumerate(got):
            want = ref.logits(params, x[:, S - 1 + i], m, "f32")
            assert rel(lg, want) < TOL, i
    assert caches["index"].tolist() == [S + steps - 1] * B


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}.{k}" if prefix else k
        out.update(flat(v, p) if isinstance(v, dict) else {p: v})
    return out


def unflat(leaves):
    out = {}
    for path, v in leaves.items():
        *heads, last = path.split(".")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def grads(fn, params):
    leaves = {p: t.detach().clone().requires_grad_(True)
              for p, t in flat(params).items()}
    loss = fn(unflat(leaves))
    gs = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, gs))


# (groups, tolerance): one hybrid layer agrees to ~3e-6; through the ten
# layers float32 rounding grows to ~3e-3 on the first layers' leaves
STACKS = {"one_hybrid_layer": ((GroupSpec((HYB,), 1),), 2e-5),
          "ten_layers": (None, 1e-2)}


@pytest.mark.parametrize("stack", sorted(STACKS))
@pytest.mark.parametrize("impl", ["full", "flash"])
def test_train_step_loss_and_gradients_match_the_reference(impl, stack):
    """Remat "full"; the attention as materialised scores or as the
    flash path (the brick scan and its backward on the CPU), both with
    the block's scale."""
    groups, tol = STACKS[stack]
    cfg = tiny(remat="full", attn_impl=impl)
    cfg = cfg.replace(groups=groups or cfg.groups)
    m, params = run_as(cfg), draw(cfg)
    seq = torch.randint(0, cfg.vocab_size, (2, 17),
                        generator=torch.Generator().manual_seed(7))
    batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
    got_loss, got = grads(lambda p: M.loss_fn(cfg, p, batch)[0], params)
    want_loss, want = grads(lambda p: ref.loss(m, p, batch["tokens"],
                                               batch["labels"]), params)
    assert abs(got_loss - want_loss) < 1e-5 * want_loss
    assert got.keys() == want.keys()
    for path in want:
        assert rel(got[path], want[path]) < tol, path


def test_each_block_gradient_is_the_sum_over_its_applications():
    """The same weights with a block of its own for each of the four
    applications (shared_blocks 4): each tied block's gradient is the sum
    of the gradients of the copies that stand for its applications."""
    cfg = tiny()
    params = draw(cfg)
    apps = sum(ls.shared_attn for g in cfg.groups
               for ls in g.layers * g.repeat)
    assert apps == 4
    untied = dict(params)
    untied["shared_attn"] = {p: v[torch.arange(apps) % 2] for p, v in
                             flat(params["shared_attn"]).items()}
    untied["shared_attn"] = unflat(untied["shared_attn"])
    seq = torch.randint(0, cfg.vocab_size, (2, 11),
                        generator=torch.Generator().manual_seed(8))
    batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
    loss, tied = grads(lambda p: M.loss_fn(cfg, p, batch)[0], params)
    loss_u, each = grads(lambda p: M.loss_fn(
        cfg.replace(shared_blocks=apps), p, batch)[0], untied)
    assert loss_u == pytest.approx(loss, rel=1e-6)
    for path, g in tied.items():
        if not path.startswith("shared_attn."):
            continue
        per_app = each[path]
        assert per_app.shape[0] == apps
        for b in range(2):
            assert float(per_app[b].norm()) > 0
            assert torch.allclose(g[b], per_app[b::2].sum(0), rtol=1e-5,
                                  atol=1e-7), (path, b)


def test_the_block_scale_reaches_every_attention_path():
    """The scores' scale of the configuration, not 1/sqrt(head_dim): the
    same prefill with the default scale differs."""
    cfg = tiny()
    params = draw(cfg)
    tok = torch.randint(0, cfg.vocab_size, (1, 9),
                        generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        a, _ = M.prefill(cfg, params, {"tokens": tok},
                         M.init_caches(cfg, 1, 9, device="cpu"))
        b, _ = M.prefill(cfg.replace(attn_scale=1 / math.sqrt(16)), params,
                         {"tokens": tok}, M.init_caches(cfg, 1, 9,
                                                        device="cpu"))
    assert rel(a, b) > 1e-3


# ------------------------------------------------ the flash scale
def _softmax_attention(q, k, v, scale, causal=True):
    """softmax(q k^T scale) v in float64, kv heads repeated (GQA)."""
    G = q.shape[2] // k.shape[2]
    k = k.double().repeat_interleave(G, dim=2)
    v = v.double().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k) * scale
    if causal:
        Sq, Sk = s.shape[-2:]
        s = s.masked_fill(torch.ones(Sq, Sk, dtype=torch.bool).triu(1),
                          float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)


@pytest.mark.parametrize("D,scale", [(224, (224 / 2) ** -0.5), (16, 0.7),
                                     (64, None)])
def test_flash_scale_plain_and_brick_match_softmax(D, scale):
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ops import brick_fwd
    gen = torch.Generator().manual_seed(D)
    q = torch.randn(2, 150, 4, D, generator=gen)
    k = torch.randn(2, 150, 2, D, generator=gen)
    v = torch.randn(2, 150, 2, D, generator=gen)
    want = _softmax_attention(q, k, v, scale or 1 / math.sqrt(D))
    for out, _ in (fk.flash_fwd_plain(q, k, v, scale=scale),
                   fk.flash_fwd(q, k, v, scale=scale),
                   brick_fwd(q, k, v, True, 0, 64, 32, scale=scale)):
        assert rel(out, want) < 1e-5
    # the default is 1/sqrt(D), bit for bit
    a, la = fk.flash_fwd_plain(q, k, v)
    b, lb = fk.flash_fwd_plain(q, k, v, scale=1 / math.sqrt(D))
    assert torch.equal(a, b) and torch.equal(la, lb)


def test_flash_scale_reaches_the_backward():
    from repro_torch.kernels.flash_attention.ops import flash_attention
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(1, 70, 2, 24, generator=gen, dtype=torch.float64,
                           requires_grad=True) for _ in range(3))
    scale = 0.37
    for impl in ("jnp", "pallas"):
        dq, dk, dv = torch.autograd.grad(
            flash_attention(q, k, v, True, 0, 32, 16, impl, scale).square()
            .sum(), (q, k, v))
        wq, wk, wv = torch.autograd.grad(
            _softmax_attention(q, k, v, scale).square().sum(), (q, k, v))
        for got, want in ((dq, wq), (dk, wk), (dv, wv)):
            assert rel(got, want) < 1e-6, impl


@pytest.mark.parametrize("D,scale", [(224, (224 / 2) ** -0.5), (128, None),
                                     (112, None)])
def test_flash_launch_takes_the_scale_it_is_given(monkeypatch, D, scale):
    """The default is resolved once, before the launch: 1/sqrt(D) as a
    double, which the C ABI rounds to the nearest float; a given scale
    goes through as it is."""
    from repro_torch.kernels.flash_attention import kernel as fk
    sent = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: sent.append((name, args)) or 0
    monkeypatch.setattr(fk, "lib", Lib)
    monkeypatch.setattr(fk, "stream", lambda device: 0)
    monkeypatch.setattr(fk, "require", lambda *a: None)   # CPU tensors
    q = torch.zeros(1, 8, 2, D, dtype=torch.bfloat16)
    fk._launch_flash_fwd(q, q, q, True, 0, scale=scale)
    (name, args), = sent
    assert name == "flash_fwd_launch"
    assert args[-2] == (1.0 / math.sqrt(D) if scale is None else scale)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch import kernels_build
    if kernels_build.find_nvcc() is None:
        pytest.skip("needs nvcc to build the kernels")
    from repro_torch.kernels.flash_attention import kernel as fk
    return fk


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_v2_at_head_dim_224_with_a_scale_matches_plain(card, dtype):
    """The shared block's shape: mma.sync (v2) at D=224, the scale
    (224/2)^-1/2, against the plain version on the same inputs."""
    fk = card
    gen = torch.Generator(device="cuda").manual_seed(11)
    q, k, v = (torch.randn(2, 300, 8, 224, generator=gen, device="cuda",
                           dtype=dtype) for _ in range(3))
    scale = (224 / 2) ** -0.5
    assert fk.flash_route(dtype, 224, q.data_ptr(), k.data_ptr(),
                          v.data_ptr(), q.data_ptr()) == "mma"
    before = fk.LAUNCHES["flash_fwd.mma"]
    out, lse = fk.flash_fwd(q, k, v, scale=scale)
    assert fk.LAUNCHES["flash_fwd.mma"] == before + 1
    want, wlse = fk.flash_fwd_plain(q.cpu(), k.cpu(), v.cpu(), scale=scale)
    assert float((out.float().cpu() - want.float()).abs().max()) < 2e-2
    assert float((lse.cpu() - wlse).abs().max()) < 1e-3
    other, _ = fk.flash_fwd(q, k, v)
    assert float((other.float() - out.float()).abs().max()) > 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("D,dtype", [(112, torch.bfloat16),
                                     (128, torch.float16),
                                     (240, torch.bfloat16),
                                     (64, torch.float32)])
def test_flash_default_scale_is_one_over_sqrt_d_bit_for_bit(card, D, dtype):
    """On every route (wgmma, mma.sync, the f32 kernel) no scale and
    1/sqrt(D) given launch the same float and give the same bits."""
    fk = card
    gen = torch.Generator(device="cuda").manual_seed(D)
    q, k, v = (torch.randn(2, 200, 4, D, generator=gen, device="cuda",
                           dtype=dtype) for _ in range(3))
    a, la = fk.flash_fwd(q, k, v)
    b, lb = fk.flash_fwd(q, k, v, scale=1 / math.sqrt(D))
    assert torch.equal(a, b) and torch.equal(la, lb)
