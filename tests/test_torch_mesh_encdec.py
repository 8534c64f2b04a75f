"""The encoder-decoder family over a (data, model) mesh: reduced
seamless-m4t-medium in f32 on 4 gloo ranks of this CPU, held against the
reference's own sharded forward and against the port's one device.

One module-scoped subprocess runs the reference (`repro`) under an
**Auto** (2, 2) mesh of 8 forced host devices, built as
`tests/test_torch_mesh_serve.py` builds it, with `infer_rules`: the
prefill of a batch of source frames and a target prompt, then greedy
decode steps (the cross k/v from the caches).  Spawned gloo ranks of the
port serve the same weights (`init_params_numpy`, attention scaled to its
fan-in as `reference_serve_encdec.json` is taken: the reference's init
rule makes the random stack chaotic) under `infer_rules` (the cross
caches' sequence over ``model``, read by a flash-decode over the
blocks) and under `DEFAULT_RULES` (the caches over ``kv_heads``, the
encoder's residual split over its own sequence): tokens equal, logits
within 2e-3 of max|logit| (the serve slice's bound).  The same ranks
take a train step of `make_train_step(cfg, opt, mesh)` and the gradients
of `loss_and_grads`, held to the port's one-device step within 1e-4
(loss) and 1e-3 (each gradient leaf, relative L2), PR 21's bounds.

Also here: the SSD block's refusal of heads and columns split over
different mesh axes, with the case that reaches it.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_mesh_serve import run_ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "seamless-m4t-medium"
SEED = 13
MESH = (2, 2)
B, S_SRC, S_PROMPT, N_DEC = 2, 32, 8, 4
TOL_MODEL, TOL_LOSS, TOL_GRAD = 2e-3, 1e-4, 1e-3


def model_cfg(pkg="repro_torch"):
    if pkg == "repro_torch":
        from repro_torch.configs.base import get_config, reduced_config
    else:
        from repro.configs.base import get_config, reduced_config
    return reduced_config(get_config(ARCH)).replace(dtype="float32")


def model_inputs():
    """(numpy weights with attention scaled to its fan-in, source frames
    (B, S_SRC, d), target prompt (B, S_PROMPT), labels), from SEED."""
    from test_torch_models import scale_attention
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import init_params_numpy
    cfg = model_cfg()
    tree = init_params_numpy(SEED, M.model_param_specs(cfg))
    scale_attention(tree)
    rng = np.random.default_rng(SEED)
    enc = (rng.standard_normal((B, S_SRC, cfg.d_model)) * 0.5
           ).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, S_PROMPT + 1)
                        ).astype(np.int32)
    return tree, enc, toks[:, :-1].copy(), toks[:, 1:].copy()


# ------------------------------ reference --------------------------------- #
_REFERENCE = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
sys.path.insert(0, sys.argv[2])
import test_torch_mesh_encdec as T
from repro.models import model as JM
from repro.parallel import sharding as JS

def tree(a):
    if isinstance(a, dict):
        return {k: tree(v) for k, v in a.items()}
    return jnp.asarray(a)

cfg = T.model_cfg("repro")
params, enc, prompt, _ = T.model_inputs()
mesh = jax.make_mesh(T.MESH, ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
rules = JS.infer_rules(cfg)
shard = JS.specs_to_shardings(JM.model_param_specs(cfg), mesh, rules)
params = jax.device_put(tree(params), shard)
caches = JS.init_params(jax.random.PRNGKey(0), JM.cache_specs_tree(
    cfg, T.B, T.S_PROMPT + T.N_DEC, src_len=T.S_SRC))
def run(fn):
    def f(p, bt, c):
        with JS.sharding_ctx(mesh, rules):
            return fn(cfg, p, bt, c)
    return jax.jit(f)
pre, dec = run(JM.prefill), run(JM.decode_step)
toks, logits = [], []
with mesh:
    lg, caches = pre(params, {"tokens": jnp.asarray(prompt),
                              "enc_embeds": jnp.asarray(enc)}, caches)
    for i in range(T.N_DEC + 1):
        lg = np.asarray(lg, np.float32)
        logits.append(lg)
        toks.append(lg.argmax(-1).astype(np.int32))
        if i == T.N_DEC:
            break
        lg, caches = dec(params, {"tokens": jnp.asarray(toks[-1][:, None])},
                         caches)
np.savez(sys.argv[1], tokens=np.stack(toks), logits=np.stack(logits))
"""


@pytest.fixture(scope="module")
def inputs():
    return model_inputs()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh_encdec_ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONHASHSEED="0",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           os.environ.get("PYTHONPATH",
                                                          "")]))
    r = subprocess.run([sys.executable, "-c", _REFERENCE, str(path),
                        str(ROOT / "tests")], env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return dict(np.load(path))


# ------------------------------- the port --------------------------------- #
def _serve(mesh, rules, full, enc, prompt):
    """Prefill and N_DEC greedy steps through the port's mesh steps:
    tokens (N_DEC+1, B), logits (N_DEC+1, B, V), whole on every rank,
    and the local shape of a cross cache."""
    from repro_torch.models import model as M
    from repro_torch.models.convert import shard_params
    from repro_torch.training.train_state import (make_decode_step,
                                                  make_prefill_step)
    cfg = model_cfg()
    params = shard_params(full, M.model_param_specs(cfg), mesh, rules,
                          device="cpu")
    caches = M.init_caches(cfg, B, S_PROMPT + N_DEC, S_SRC, mesh=mesh,
                           rules=rules, device="cpu")
    pre = make_prefill_step(cfg, mesh, rules, return_logits=True)
    dec = make_decode_step(cfg, mesh, rules, return_logits=True)
    tok, caches, lg = pre(params, {"tokens": torch.as_tensor(prompt),
                                   "enc_embeds": torch.as_tensor(enc)},
                          caches)
    toks, logits = [tok.numpy()], [lg.numpy()]
    for _ in range(N_DEC):
        tok, caches, lg = dec(params, {"tokens": tok[:, None]}, caches)
        toks.append(tok.numpy())
        logits.append(lg.numpy())
    cross = tuple(caches["decoder"]["g0"]["L0"]["cross_k"].shape)
    return np.stack(toks), np.stack(logits), cross


def _flat(tree):
    from repro_torch.parallel.sharding import tree_leaves_with_path
    return {p: t.detach().numpy().copy()
            for p, t in tree_leaves_with_path(tree)}


def _train(mesh, full, batch):
    """One train step's loss and the gathered gradients of
    `loss_and_grads` on this rank (`DEFAULT_RULES`)."""
    from repro_torch.models import model as M
    from repro_torch.models.convert import gather_params, shard_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.sharding import DEFAULT_RULES
    from repro_torch.training.train_state import (loss_and_grads,
                                                  make_train_step)
    cfg = model_cfg()
    specs = M.model_param_specs(cfg)
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    params = shard_params(full, specs, mesh, DEFAULT_RULES, device="cpu")
    met, grads = loss_and_grads(cfg, params, batch, mesh)
    zeros = lambda t: {k: zeros(v) for k, v in t.items()} \
        if isinstance(t, dict) else torch.zeros_like(t)  # noqa: E731
    state = {"params": params, "opt": {"m": zeros(params),
                                       "v": zeros(params)},
             "step": torch.zeros((), dtype=torch.int32)}
    _, step_met = make_train_step(cfg, AdamWConfig(), mesh)(state, batch)
    return {"loss": float(met["loss"]), "step_loss": float(step_met["loss"]),
            "grads": _flat(gather_params(grads, specs, mesh,
                                         DEFAULT_RULES))}


def encdec_rank(rank, full, enc, prompt, labels):
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.sharding import DEFAULT_RULES, infer_rules
    mesh = make_host_mesh(*MESH)
    out = {"infer": _serve(mesh, infer_rules(model_cfg()), full, enc,
                           prompt),
           "default": _serve(mesh, DEFAULT_RULES, full, enc, prompt)}
    train = _train(mesh, full, {"enc_embeds": enc, "tokens": prompt,
                                "labels": labels})
    if rank:
        train.pop("grads")
    out["train"] = train
    return out


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    return run_ranks(encdec_rank, 4, tmp_path_factory.mktemp("encdec"),
                     *inputs, limit=300.0)


def _rel(want, got):
    return float(np.abs(np.asarray(want, np.float64) - got).max()
                 / np.abs(np.asarray(want, np.float64)).max())


# a rank's block of the (repeat, B, S_SRC, Hkv, D) cross caches: the
# sequence over model (infer_rules) or the kv heads (DEFAULT_RULES)
CROSS_BLOCK = {"infer": (2, 1, S_SRC // 2, 2, 16),
               "default": (2, 1, S_SRC, 1, 16)}


@pytest.mark.parametrize("rules", ["infer", "default"])
def test_serve_on_a_mesh_matches_the_reference(reference, ranks, rules):
    """Every rank's tokens equal the reference's sharded prefill and
    decode; its logits within 2e-3 of max|logit|."""
    for r, out in enumerate(ranks):
        toks, logits, cross = out[rules]
        assert cross == CROSS_BLOCK[rules], (rules, r)
        assert np.array_equal(toks, reference["tokens"]), (rules, r)
        assert _rel(reference["logits"], logits) < TOL_MODEL, (rules, r)


def test_train_step_on_a_mesh_matches_one_device(inputs, ranks):
    """The mesh's loss (every rank, `loss_and_grads` and the train step)
    within 1e-4 of one device's, each gathered gradient leaf within 1e-3
    (relative L2)."""
    from repro_torch.models.convert import params_from_reference
    from repro_torch.models import model as M
    from repro_torch.training.train_state import loss_and_grads
    full, enc, prompt, labels = inputs
    cfg = model_cfg()
    params = params_from_reference(full, M.model_param_specs(cfg),
                                   device="cpu")
    met, grads = loss_and_grads(cfg, params, {
        "enc_embeds": torch.as_tensor(enc), "tokens": torch.as_tensor(prompt),
        "labels": torch.as_tensor(labels)})
    loss = float(met["loss"])
    for out in ranks:
        assert abs(out["train"]["loss"] - loss) < TOL_LOSS * abs(loss)
        assert abs(out["train"]["step_loss"] - loss) < TOL_LOSS * abs(loss)
    got = ranks[0]["train"]["grads"]
    want = _flat(grads)
    assert got.keys() == want.keys()
    assert any("cross" in p for p in want) and any(
        p.startswith("encoder") for p in want)
    for path, w in want.items():
        err = np.linalg.norm(got[path] - w) / max(np.linalg.norm(w), 1e-30)
        assert err < TOL_GRAD, (path, err)


def test_ssd_block_refuses_heads_and_columns_on_different_axes():
    """`ssd_block` keeps its refusal where ``ssm_heads`` and
    ``ssm_inner`` would split over different mesh axes.  Under the port's
    rules both map to ``model``, so it is reached only where the head
    count does not divide the model axis while ``d_inner`` does: here 4
    heads of 32 over a model axis of 8 (d_inner 128).  No registered
    config with an SSD layer reaches it on the production meshes (model
    axis 8)."""
    from repro_torch.configs.base import ARCH_IDS, get_config, reduced_config
    from repro_torch.models import ssm
    from repro_torch.parallel import sharding as S
    cfg = reduced_config(get_config("zamba2-7b")).replace(
        dtype="float32", ssm_head_dim=32)
    assert (cfg.ssm_nheads, cfg.d_inner) == (4, 128)
    mesh = {"data": 1, "model": 8}
    params = S.init_params(0, ssm.ssd_specs(cfg), device="cpu")
    x = torch.zeros((1, 8, cfg.d_model))
    with S.sharding_ctx(mesh, S.INFERENCE_RULES, batch=1, seq=8):
        with pytest.raises(NotImplementedError, match="different mesh axes"):
            ssm.ssd_block(params, x, cfg, mode="train")
    for arch in ARCH_IDS:
        c = get_config(arch)
        if any(ls.mixer == "ssd" for g in c.groups for ls in g.layers):
            for rules in (S.DEFAULT_RULES, S.infer_rules(c)):
                prod = {"pod": 2, "data": 16, "model": 8}
                assert S._fit_axes(prod, c.ssm_nheads,
                                   rules.mesh_axes("ssm_heads")) == \
                    S._fit_axes(prod, c.d_inner,
                                rules.mesh_axes("ssm_inner")), arch
