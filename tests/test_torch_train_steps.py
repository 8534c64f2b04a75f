"""Whole train steps of the port against the reference package on the CPU:
reduced zamba2-7b (SSD + shared attention) and the tiny granite of
`tests/test_trainer.py`, started from one state (the reference's init,
carried over with `state_from_reference`), with and without the kernels'
plain versions, with micro-steps and with activation checkpointing.

Tolerances, f32: each step's loss, and each final parameter leaf (L2),
within 1e-5 relative of the reference's, or within 3x the reference's own
spread where that is larger: the reference run again from the same state
moved by one ulp (`hold_steps`).  Random reduced zamba2 under Adam is
chaotic at f32 rounding: one ulp moves the reference's own loss ~1e-2 by
step 3.  The tiny granite stays inside 1e-5, and its first step is held
to 1e-5 with no allowance.  Reduced zamba2's first-step gradient (no Adam
step; the shared attention scaled as `chip_smoke.py` scales it) is held
leaf by leaf to `jax.grad` of the reference's loss, within 1e-5 or 3x the
reference's own one-ulp spread of that gradient (at most ~8e-5 of a
leaf's norm).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.base import reduced_config as jax_reduced  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.training.train_state import \
    init_train_state as jax_init_state  # noqa: E402
from repro.training.train_state import \
    make_train_step as jax_train_step  # noqa: E402

from repro_torch.configs.base import get_config, reduced_config  # noqa: E402
from repro_torch.models.convert import (state_from_reference,  # noqa: E402
                                        state_to_numpy)
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.parallel.sharding import tree_leaves_with_path  # noqa: E402
from repro_torch.training.train_state import (loss_and_grads,  # noqa: E402
                                              make_train_step)

REL = 1e-5


def rel_err(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    got = got.detach().double().numpy()
    return float(np.max(np.abs(ref - got))) / max(
        float(np.max(np.abs(ref))), 1e-30)


def t(a):
    return torch.from_numpy(np.array(a))


def granite_kw():
    """The tiny granite of `tests/test_trainer.py:18`, in f32."""
    return dict(vocab_size=64, d_model=32, num_heads=4, num_kv_heads=2,
                head_dim=8, d_ff=64)


def train_cfgs(arch, **kw):
    kw = dict(dtype="float32", **kw)
    if arch == "granite-8b":
        kw.update(granite_kw())
    return (jax_reduced(jax_get_config(arch)).replace(**kw),
            reduced_config(get_config(arch)).replace(**kw))


def batches(cfg, n, B=4, S=32, seed=8):
    rs = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rs.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


def start_state(jcfg, cfg, seed=0):
    """One state in both packages: the reference's init, carried over."""
    jstate = jax_init_state(jax.random.PRNGKey(seed), jcfg)
    return jstate, state_from_reference(jax.device_get(jstate), cfg,
                                        device="cpu")


@functools.lru_cache(maxsize=None)
def jax_step(jcfg, opt):
    """The reference's jitted train step, compiled once per config."""
    return jax.jit(jax_train_step(jcfg, jax_adamw.AdamWConfig(**dict(opt))))


def nudged(state, direction):
    """The state with every f32 parameter moved by one ulp."""
    def f(a):
        a = np.asarray(a)
        return (np.nextafter(a, np.float32(direction * np.inf)).astype(a.dtype)
                if a.dtype == np.float32 else a)
    return {**state, "params": jax.tree_util.tree_map(f, state["params"])}


def hold_steps(jcfg, cfg, seed, steps, opt, spread=3.0):
    """``steps`` train steps from one state in both packages, and in the
    reference from the same state moved by one ulp up and down.  Each
    step's loss, and each final parameter leaf (L2), must lie within
    1e-5 relative of the reference's, or within ``spread`` times the
    reference's own distance to its nudged runs where that is larger:
    Adam turns f32 rounding of near-zero gradient entries into lr-sized
    steps, and a random zamba2 amplifies them (one ulp moves the
    reference's loss ~1e-2 by the third step at lr 3e-3)."""
    jstate, state = start_state(jcfg, cfg, seed)
    host = jax.device_get(jstate)
    runs = [jstate] + [jax.tree_util.tree_map(jnp.asarray, nudged(host, d))
                       for d in (1, -1)]
    jstep = jax_step(jcfg, tuple(sorted(opt.items())))
    step = make_train_step(cfg, AdamWConfig(**opt))
    for i, b in enumerate(steps):
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        outs = [jstep(r, jb) for r in runs]
        runs = [o[0] for o in outs]
        state, m = step(state, {k: t(v) for k, v in b.items()})
        ref = float(outs[0][1]["loss"])
        floor = max(abs(ref - float(o[1]["loss"])) for o in outs[1:])
        err = abs(ref - float(m["loss"]))
        assert err <= max(1e-5 * abs(ref), spread * floor), (i, err, floor)
    assert int(state["step"]) == int(runs[0]["step"]) == len(steps)
    got = dict(tree_leaves_with_path(state["params"]))
    near = [dict(tree_leaves_with_path(jax.device_get(r["params"])))
            for r in runs[1:]]
    for path, a in tree_leaves_with_path(jax.device_get(runs[0]["params"])):
        a = np.asarray(a, np.float64)
        err = np.linalg.norm(a - got[path].double().numpy())
        floor = max(np.linalg.norm(a - n[path]) for n in near)
        assert err <= max(1e-5 * np.linalg.norm(a), spread * floor), \
            (path, err, floor)
    return state


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("arch", ["zamba2-7b", "granite-8b"])
def test_train_steps_match_reference(arch, use_pallas):
    """5 train steps from one state: the loss trajectory and the final
    params.  With ``use_pallas`` the port runs its kernels' plain versions
    under `SSDScan` / `FlashAttention` (``attn_impl="flash"`` reaches the
    flash path at S <= 1024), against the reference's jnp paths."""
    jcfg, cfg = train_cfgs(arch)
    if use_pallas:
        cfg = cfg.replace(use_pallas=True, attn_impl="flash")
    hold_steps(jcfg, cfg, 0, batches(cfg, 5), dict(lr=3e-3, warmup_steps=2))


def test_first_step_matches_reference_granite():
    """The tiny granite is well conditioned: one step's metrics (max
    error) and params (L2) within 1e-5 of the reference's, with no
    allowance."""
    jcfg, cfg = train_cfgs("granite-8b")
    jstate, state = start_state(jcfg, cfg)
    opt = dict(lr=3e-3, warmup_steps=2)
    (b,) = batches(cfg, 1)
    js, jm = jax.jit(jax_train_step(jcfg, jax_adamw.AdamWConfig(**opt)))(
        jstate, {k: jnp.asarray(v) for k, v in b.items()})
    s, m = make_train_step(cfg, AdamWConfig(**opt))(
        state, {k: t(v) for k, v in b.items()})
    for key in ("loss", "nll", "aux", "grad_norm", "lr"):
        assert rel_err(jm[key], m[key]) < REL, key
    assert_params_close(js["params"], s["params"])


@functools.lru_cache(maxsize=None)
def jax_loss_grads(jcfg):
    """The reference's first-step gradient, jitted once per config:
    `jax.grad` of its loss, with the masters cast as its train step casts
    them."""
    def lf(p, b):
        half = jax.tree_util.tree_map(
            lambda x: x.astype(jcfg.act_dtype)
            if x.dtype == jnp.float32 and x.ndim >= 2 else x, p)
        return jax_model.loss_fn(jcfg, half, b)
    return jax.jit(jax.value_and_grad(lf, has_aux=True))


def conditioned(host, cfg):
    """The host state with the shared attention scaled to a fan-in of
    d_model, as `chip_smoke.py`'s `condition_attention` scales it: the
    reference's init takes a rank-3 weight's head count as its fan-in, and
    the saturated softmax then moves the f32 gradient ~2e-3 under a
    one-ulp nudge of the start state (~8e-5 once scaled)."""
    params = jax.tree_util.tree_map(np.array, host["params"])
    a, h = params["shared_attn"]["attn"], cfg.shared_attn_heads
    for name in ("wq", "wk", "wv"):
        a[name] *= np.float32((h / cfg.d_model) ** 0.5)
    a["wo"] *= np.float32((1.0 / h) ** 0.5)
    return {**host, "params": params}


@pytest.mark.parametrize("use_pallas,remat", [(False, "none"),
                                              (True, "none"),
                                              (True, "full")])
def test_first_step_grads_match_reference_zamba2(use_pallas, remat):
    """Reduced zamba2's whole-model loss and gradient at step 0 (no Adam
    step), leaf by leaf against `jax.grad` of the reference's loss: the
    loss within 1e-5, each leaf within 1e-5 relative L2, or within 3x the
    reference's own distance to its gradients from the start state moved
    one ulp up and down, where that is larger (at most ~8e-5 of a leaf's
    norm here).  With ``use_pallas`` the port's SSD scan and flash
    attention run under `SSDScan` / `FlashAttention`, with ``remat``
    "full" inside activation checkpointing, against the reference's
    `jax.checkpoint`."""
    jcfg, cfg = train_cfgs("zamba2-7b", remat=remat)
    if use_pallas:
        cfg = cfg.replace(use_pallas=True, attn_impl="flash")
    jstate, _ = start_state(jcfg, cfg, seed=4)
    host = conditioned(jax.device_get(jstate), cfg)
    state = state_from_reference(host, cfg, device="cpu")
    (b,) = batches(cfg, 1, seed=9)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    grad_fn = jax_loss_grads(jcfg)
    (jloss, _), jg = grad_fn(
        jax.tree_util.tree_map(jnp.asarray, host["params"]), jb)
    near = [grad_fn(jax.tree_util.tree_map(
        jnp.asarray, nudged(host, d)["params"]), jb)[1] for d in (1, -1)]
    met, grads = loss_and_grads(cfg, state["params"],
                                {k: t(v) for k, v in b.items()})
    assert rel_err(jloss, met["loss"]) < REL
    got = dict(tree_leaves_with_path(grads))
    near = [dict(tree_leaves_with_path(jax.device_get(n))) for n in near]
    assert set(got) == {p for p, _ in tree_leaves_with_path(
        jax.device_get(jg))}
    for path, a in tree_leaves_with_path(jax.device_get(jg)):
        a = np.asarray(a, np.float64)
        err = np.linalg.norm(a - got[path].double().numpy())
        floor = max(np.linalg.norm(a - n[path]) for n in near)
        assert err <= max(REL * np.linalg.norm(a), 3.0 * floor), \
            (path, err, floor, np.linalg.norm(a))


def assert_params_close(jparams, tparams, tol=1e-5):
    """Each leaf within ``tol`` relative L2 of the reference's."""
    got = dict(tree_leaves_with_path(tparams))
    for path, a in tree_leaves_with_path(jax.device_get(jparams)):
        a = np.asarray(a, np.float64)
        err = np.linalg.norm(a - got[path].double().numpy())
        assert err <= tol * np.linalg.norm(a), (path, err)


@pytest.mark.parametrize("arch", ["zamba2-7b", "granite-8b"])
def test_micro_steps_match_reference(arch):
    """Gradient accumulation over 2 micro-batches (batch-major split)."""
    jcfg, cfg = train_cfgs(arch, micro_steps=2)
    hold_steps(jcfg, cfg, 1, batches(cfg, 2, B=4, S=16),
               dict(warmup_steps=2))


def test_remat_full_matches_none_and_reference():
    """Activation checkpointing of each repeat (``remat="full"``) changes
    no gradient: against ``"none"`` bit for bit, and against the
    reference's remat'd step."""
    jcfg, cfg = train_cfgs("zamba2-7b", remat="full")
    assert cfg.remat == "full"
    _, state = start_state(jcfg, cfg, seed=2)
    (b,) = batches(cfg, 1, B=2, S=16)
    tb = {k: t(v) for k, v in b.items()}
    m_full, g_full = loss_and_grads(cfg, state["params"], tb)
    m_none, g_none = loss_and_grads(cfg.replace(remat="none"),
                                    state["params"], tb)
    assert torch.equal(m_full["loss"], m_none["loss"])
    for (path, a), (_, b_) in zip(tree_leaves_with_path(g_full),
                                  tree_leaves_with_path(g_none)):
        assert torch.equal(a, b_), path


def test_state_round_trip_through_numpy():
    jcfg, cfg = train_cfgs("granite-8b")
    _, state = start_state(jcfg, cfg)
    back = state_from_reference(state_to_numpy(state), cfg, device="cpu")
    for (path, a), (_, b) in zip(tree_leaves_with_path(state),
                                 tree_leaves_with_path(back)):
        assert a.dtype == b.dtype and torch.equal(a, b), path
        assert a.data_ptr() != b.data_ptr(), path
