"""The port's training path against the reference package on the CPU, part
by part: the losses, the flash and SSD gradients, AdamW and its schedule,
gradient compression and SDC fingerprints (whole train steps:
`tests/test_torch_train_steps.py`).

Inputs come from numpy seeds and are handed to both packages; the
reference's functions are called as its own tests call them (jitted, the
flash and SSD gradients through `jax.grad`).  Tolerances, all f32:
- flash gradients 2e-5 absolute, the bound of the reference's
  `tests/test_kernels.py::test_flash_grads_match_reference`;
- losses, SSD gradients, AdamW, compression: 1e-5 relative to the largest
  magnitude (f32 rounding of sums taken in another order);
- fingerprints: equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.cluster.sdc import gradient_fingerprint as jax_fingerprint  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.base import reduced_config as jax_reduced  # noqa: E402
from repro.kernels.flash_attention.ops import \
    flash_attention as jax_flash  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.ssm import ssd_scan as jax_ssd_scan  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.optim import compression as jax_comp  # noqa: E402

from repro_torch.cluster.sdc import gradient_fingerprint  # noqa: E402
from repro_torch.configs.base import get_config, reduced_config  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.ssd.ops import ssd  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.optim import compression as comp  # noqa: E402
from repro_torch.optim.adamw import (AdamWConfig, adamw_update,  # noqa: E402
                                     lr_schedule)
from repro_torch.parallel.sharding import (init_params_numpy,  # noqa: E402
                                           tree_leaves_with_path)

REL = 1e-5


def rel_err(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    got = (got.detach().double().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float64))
    return float(np.max(np.abs(ref - got))) / max(
        float(np.max(np.abs(ref))), 1e-30)


def t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------- losses ---------------------------------- #
def loss_cfgs(loss_chunk):
    kw = dict(dtype="float32", loss_chunk=loss_chunk)
    return (jax_reduced(jax_get_config("zamba2-7b")).replace(**kw),
            reduced_config(get_config("zamba2-7b")).replace(**kw))


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked):
    rs = np.random.default_rng(0)
    logits = rs.standard_normal((2, 12, 50)).astype(np.float32) * 3
    labels = rs.integers(0, 50, (2, 12)).astype(np.int32)
    mask = (rs.random((2, 12)) > 0.3).astype(np.int32) if masked else None
    ref = JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                           None if mask is None else jnp.asarray(mask))
    got = L.cross_entropy(t(logits), t(labels),
                          None if mask is None else t(mask))
    assert rel_err(ref, got) < REL


# loss_chunk 0 (one einsum), 8 (S=24 in 3 chunks), 16 (S % c != 0: the
# reference's c = S // (S // c) rule, 24 here), 64 (S <= c)
@pytest.mark.parametrize("loss_chunk", [0, 8, 16, 64])
@pytest.mark.parametrize("masked", [False, True])
def test_lm_head_loss_and_grads_match_reference(loss_chunk, masked):
    jcfg, cfg = loss_cfgs(loss_chunk)
    rs = np.random.default_rng(1)
    B, S = 2, 24
    p = init_params_numpy(3, {"e": L.embed_specs(cfg)})["e"]
    p["final_norm"] = rs.standard_normal(p["final_norm"].shape).astype(
        np.float32) * 0.1
    x = rs.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    labels = rs.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    mask = (rs.random((B, S)) > 0.3).astype(np.int32) if masked else None

    def jf(params, x):
        return JL.lm_head_loss(params, x, jnp.asarray(labels), jcfg,
                               None if mask is None else jnp.asarray(mask))
    jloss, (jgp, jgx) = jax.jit(jax.value_and_grad(jf, argnums=(0, 1)))(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    tp = {k: t(v).requires_grad_() for k, v in p.items()}
    tx = t(x).requires_grad_()
    loss = L.lm_head_loss(tp, tx, t(labels), cfg,
                          None if mask is None else t(mask))
    loss.backward()
    assert rel_err(jloss, loss) < REL
    assert rel_err(jgx, tx.grad) < REL
    for k in p:
        g = tp[k].grad
        if g is None:           # untied embedding: not on the loss's path
            assert not np.any(np.asarray(jgp[k])), k
            continue
        assert rel_err(jgp[k], g) < REL, k


# --------------------------- flash backward ------------------------------ #
FLASH_GRAD_CASES = [
    # B, Sq, Skv, Hq, Hkv, D, causal, window, cq, ck
    (2, 96, 96, 4, 2, 16, True, 0, 32, 32),     # tests/test_kernels.py:70
    (1, 64, 64, 8, 2, 16, True, 0, 32, 16),     # GQA 4:1, cq != ck
    (2, 128, 128, 4, 2, 16, True, 24, 32, 32),  # sliding window
    (1, 100, 100, 4, 4, 16, True, 0, 32, 32),   # ragged S
    (2, 64, 100, 4, 2, 16, False, 0, 32, 32),   # cross, ragged Skv
]


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("case", FLASH_GRAD_CASES)
def test_flash_backward_matches_jax_grad(case, impl):
    """The backward behind either forward (the brick scan, or the
    kernel's plain version on CPU tensors) against `jax.grad` of the
    reference's `flash_attention(..., "jnp")`, to the reference's 2e-5."""
    B, Sq, Skv, Hq, Hkv, D, causal, window, cq, ck = case
    rs = np.random.default_rng(2)
    q, k, v = (rs.standard_normal(s).astype(np.float32)
               for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))

    def jf(q, k, v):
        return jnp.sum(jnp.sin(jax_flash(q, k, v, causal, window, cq, ck,
                                         "jnp")))
    jg = jax.jit(jax.grad(jf, argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (t(a).requires_grad_() for a in (q, k, v))
    torch.sum(torch.sin(flash_attention(tq, tk, tv, causal, window, cq, ck,
                                        impl))).backward()
    for a, b in zip(jg, (tq.grad, tk.grad, tv.grad)):
        assert b.dtype == torch.float32
        assert float(np.max(np.abs(np.asarray(a) - b.numpy()))) < 2e-5


# ------------------------------ SSD gradient ----------------------------- #
SSD_CASES = [
    # B, S, H, P, G, N, chunk (tests/test_kernels.py's cases)
    (2, 64, 4, 16, 1, 16, 16),
    (1, 96, 2, 32, 1, 8, 32),
    (2, 128, 4, 16, 2, 16, 64),
    (1, 50, 2, 16, 1, 16, 16),   # ragged
]


def ssd_inputs(case, seed):
    B, S, H, P, G, N, _ = case
    rs = np.random.default_rng(seed)
    x = rs.standard_normal((B, S, H, P)).astype(np.float32)
    dt = (rs.random((B, S, H)) * 0.5 + 0.01).astype(np.float32)
    A = -np.exp(rs.standard_normal(H)).astype(np.float32)
    Bm = rs.standard_normal((B, S, G, N)).astype(np.float32)
    Cm = rs.standard_normal((B, S, G, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_scan_grads_match_jax_grad(case):
    """`SSDScan` (the kernel's plain version forward, the chunked scan's
    backward) against `jax.grad` of the reference's jnp `ssd_scan`, through
    y and the final state."""
    chunk = case[-1]
    ins = ssd_inputs(case, 3)
    rs = np.random.default_rng(4)
    wy = rs.standard_normal(ins[0].shape).astype(np.float32)

    def jf(*a):
        y, fin = jax_ssd_scan(*a, chunk)
        return jnp.sum(y * wy) + jnp.sum(jnp.sin(fin))
    jg = jax.jit(jax.grad(jf, argnums=(0, 1, 2, 3, 4)))(
        *map(jnp.asarray, ins))
    tins = [t(a).requires_grad_() for a in ins]
    y, fin = ssd(*tins, chunk=chunk, impl="pallas")
    (torch.sum(y * t(wy)) + torch.sum(torch.sin(fin))).backward()
    for name, a, b in zip("x dt A B C".split(), jg, tins):
        assert rel_err(a, b.grad) < 1e-5, name


def test_ssd_scan_grads_finite_at_a_long_chunk():
    """At zamba2's chunk of 256 with dt near 0.7 the segment sums reach
    ~180: the reference's ``where(tri, exp(diff), 0)`` overflows in the
    masked triangle and its gradient is NaN; the port masks before the
    exp, so its f32 gradients are finite and equal its f64 ones."""
    rs = np.random.default_rng(9)
    B, S, H, P, N, chunk = 1, 256, 2, 8, 8, 256
    x = rs.standard_normal((B, S, H, P)).astype(np.float32)
    dt = (0.6 + 0.2 * rs.random((B, S, H))).astype(np.float32)
    A = -np.ones(H, np.float32)
    Bm = rs.standard_normal((B, S, 1, N)).astype(np.float32)
    Cm = rs.standard_normal((B, S, 1, N)).astype(np.float32)
    ins = (x, dt, A, Bm, Cm)

    def jf(*a):
        y, _ = jax_ssd_scan(*a, chunk)
        return jnp.sum(jnp.sin(y))
    jg = jax.jit(jax.grad(jf, argnums=(0, 1, 2, 3, 4)))(
        *map(jnp.asarray, ins))
    assert not all(np.isfinite(np.asarray(g)).all() for g in jg)
    grads = {}
    for dtype in (torch.float32, torch.float64):
        tins = [t(a).to(dtype).requires_grad_() for a in ins]
        y, _ = ssd(*tins, chunk=chunk, impl="pallas")
        torch.sum(torch.sin(y)).backward()
        grads[dtype] = [a.grad for a in tins]
    for name, a, b in zip("x dt A B C".split(), grads[torch.float32],
                          grads[torch.float64]):
        assert bool(torch.isfinite(a).all()), name
        assert rel_err(b, a) < 1e-4, name


# ------------------------------ optimizer -------------------------------- #
def test_lr_schedule_matches_reference():
    cfg = AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=100)
    jcfg = jax_adamw.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=100)
    for step in (0, 5, 9, 10, 11, 50, 99, 100, 150):
        ref = jax_adamw.lr_schedule(jcfg, jnp.asarray(step, jnp.int32))
        got = lr_schedule(cfg, torch.tensor(step, dtype=torch.int32))
        assert rel_err(ref, got) < 1e-6, step


@pytest.mark.parametrize("step", [0, 7])
def test_adamw_update_matches_reference(step):
    rs = np.random.default_rng(5)
    shapes = {"w": (6, 5), "b": (5,), "s": {"k": (2, 3, 4)}}

    def draw(scale=1.0):
        return {"w": rs.standard_normal(shapes["w"]).astype(np.float32) * scale,
                "b": rs.standard_normal(shapes["b"]).astype(np.float32) * scale,
                "s": {"k": rs.standard_normal(shapes["s"]["k"]).astype(
                    np.float32) * scale}}
    p, g = draw(), draw(3.0)
    m, v = draw(0.1), {k: x for k, x in draw(0.1).items()}
    v = jax.tree_util.tree_map(np.abs, v)
    jcfg = jax_adamw.AdamWConfig(warmup_steps=3)
    jp, jo, js = jax_adamw.adamw_update(
        jcfg, *jax.tree_util.tree_map(jnp.asarray, (p, g, {"m": m, "v": v})),
        jnp.asarray(step, jnp.int32))
    tp = params_from_reference(p, device="cpu")
    to = {"m": params_from_reference(m, device="cpu"),
          "v": params_from_reference(v, device="cpu")}
    np_, no, ts = adamw_update(AdamWConfig(warmup_steps=3), tp,
                               params_from_reference(g, device="cpu"), to,
                               torch.tensor(step, dtype=torch.int32))
    for (path, a), (_, b) in zip(tree_leaves_with_path(jp),
                                 tree_leaves_with_path(np_)):
        assert rel_err(a, b) < REL, path
    for key in ("m", "v"):
        for (path, a), (_, b) in zip(tree_leaves_with_path(jo[key]),
                                     tree_leaves_with_path(no[key])):
            assert rel_err(a, b) < REL, (key, path)
    for key in ("grad_norm", "lr"):
        assert rel_err(js[key], ts[key]) < REL, key


# ------------------------ compression, fingerprints ---------------------- #
@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_compress_tree_matches_reference(scheme):
    rs = np.random.default_rng(6)
    grads = [{"a": rs.standard_normal((8, 16)).astype(np.float32),
              "b": {"c": rs.standard_normal((40,)).astype(np.float32),
                    "d": np.float32(0.5)}} for _ in range(3)]
    # ties at the top-k threshold: the reference keeps every one (>=)
    grads[0]["b"]["c"][:6] = 2.5
    kept = []
    jcfg = jax_comp.CompressionConfig(scheme=scheme, topk_frac=0.1)
    cfg = comp.CompressionConfig(scheme=scheme, topk_frac=0.1)
    jerr = terr = None
    for g in grads:
        jg, jerr = jax_comp.compress_tree(
            jax.tree_util.tree_map(jnp.asarray, g), jerr, jcfg)
        tg, terr = comp.compress_tree(
            {"a": t(g["a"]), "b": {"c": t(g["b"]["c"]),
                                   "d": torch.tensor(g["b"]["d"])}},
            terr, cfg)
        for (path, a), (_, b) in zip(tree_leaves_with_path(jg),
                                     tree_leaves_with_path(tg)):
            assert rel_err(a, b) < REL, path
        for (path, a), (_, b) in zip(tree_leaves_with_path(jerr),
                                     tree_leaves_with_path(terr)):
            assert float(np.max(np.abs(np.asarray(a) - b.numpy()))) <= \
                REL * max(1.0, float(np.max(np.abs(g["a"])))), path
        kept.append(int((tg["b"]["c"] != 0).sum()))
    if scheme == "topk":        # k = 4 of 40, and all 6 tied entries kept
        assert kept[0] == 6


def test_gradient_fingerprint_equals_reference():
    """The f64 sums depend on the leaves' order: the port walks them as
    jax flattens the tree (keys sorted), so the fingerprints are equal."""
    rs = np.random.default_rng(7)
    tree = {"z": rs.standard_normal((5, 7)).astype(np.float32),
            "a": {"y": rs.standard_normal((33,)).astype(np.float32) * 1e3,
                  "b": rs.standard_normal((2, 2, 2)).astype(np.float32)},
            "m": {"s": np.float32(3.25),
                  "v": rs.standard_normal(4).astype(np.float32)}}
    ref = jax_fingerprint(jax.tree_util.tree_map(jnp.asarray, tree))
    assert gradient_fingerprint(tree) == ref
    ttree = {"z": t(tree["z"]), "a": {"y": t(tree["a"]["y"]),
                                      "b": t(tree["a"]["b"])},
             "m": {"s": torch.tensor(3.25), "v": t(tree["m"]["v"])}}
    assert gradient_fingerprint(ttree) == ref
