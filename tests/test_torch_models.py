"""The port's model stack and serving engine against the reference package
on the CPU, with the same weights handed to both (drawn with numpy by the
reference's init rule, carried over by `params_from_reference`).

For reduced configs of zamba2-7b (SSD + shared attention), mamba2-2.7b
(pure SSD), granite-8b (dense GQA), gemma3-12b (sliding-window layers
with a ring cache), qwen3-14b (qk-norm), internlm2-20b, qwen2-vl-2b
(mrope), qwen3-moe-30b-a3b and llama4-scout-17b-a16e (MoE; llama4 top-1
with a shared expert) and seamless-m4t-medium (encoder-decoder: the
encoder frames go with the forward and the prefill, decode reads the
cross caches), in f32: train-mode logits, prefill logits and every cache
leaf, and 7 decode steps, with the torch paths and with the kernels (the
reference's Pallas kernels in interpret mode, the port's kernels' plain
versions).

Run as a script it writes the reference files that `chip_smoke.py` holds
the port to on the card, from the reference on the CPU in f32:
``--write-reference-serve`` `src/repro_torch/reference_serve.json`
(zamba2-7b at full width, 7 layers), ``--write-reference-serve-moe``
`reference_serve_moe.json` (qwen3-moe-30b-a3b at full width, 2 layers,
with every MoE call's routing) and ``--write-reference-serve-encdec``
`reference_serve_encdec.json` (seamless-m4t-medium whole):

    PYTHONPATH=src python tests/test_torch_models.py --write-reference-serve
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ARCH_IDS, get_config as jax_get_config  # noqa: E402
from repro.configs.base import reduced_config as jax_reduced  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.parallel.sharding import ParamSpec as JParamSpec  # noqa: E402
from repro.parallel.sharding import init_params as jax_init_params  # noqa: E402
from repro.serving.engine import ServeConfig as JServeConfig  # noqa: E402
from repro.serving.engine import ServingEngine as JServingEngine  # noqa: E402
from repro.training.train_state import \
    make_decode_step as jax_decode_step  # noqa: E402
from repro.training.train_state import \
    make_prefill_step as jax_prefill_step  # noqa: E402

from repro_torch.configs.base import get_config, reduced_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.parallel.sharding import (init_params,  # noqa: E402
                                           init_params_numpy,
                                           tree_leaves_with_path)
from repro_torch.serving.engine import ServeConfig, ServingEngine  # noqa: E402
from repro_torch.training.train_state import (make_decode_step,  # noqa: E402
                                              make_prefill_step)

ROOT = Path(__file__).resolve().parents[1]
SERVE_FILE = ROOT / "src" / "repro_torch" / "reference_serve.json"
ARCHS = ["zamba2-7b", "mamba2-2.7b", "granite-8b", "gemma3-12b",
         "qwen3-14b", "internlm2-20b", "qwen2-vl-2b", "qwen3-moe-30b-a3b",
         "llama4-scout-17b-a16e", "seamless-m4t-medium"]
SRC_LEN = 8                 # encoder frames of the enc-dec cases
# relative to the largest |logit|; the bound tests/test_models.py holds
# prefill/decode to against the full forward
TOL = 2e-3


def configs(arch, **kw):
    """The same reduced config in both packages (f32)."""
    kw = dict(dtype="float32", **kw)
    if arch == "gemma3-12b":
        kw["window_size"] = 4       # cache of 4 < the 5-token prompt: ring
    return (jax_reduced(jax_get_config(arch)).replace(**kw),
            reduced_config(get_config(arch)).replace(**kw))


def shared_params(cfg, seed):
    tree = init_params_numpy(seed, M.model_param_specs(cfg))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jparams, params_from_reference(tree, M.model_param_specs(cfg),
                                          device="cpu")


def scale_err(ref, got):
    ref = np.asarray(ref, np.float32)
    got = got.float().numpy()
    return float(np.max(np.abs(ref - got))) / float(np.max(np.abs(ref)))


def leaves(tree):
    return dict(tree_leaves_with_path(tree))


def jbatch(**arrays):
    return {k: jnp.asarray(v) for k, v in arrays.items()}


def tbatch(**arrays):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in arrays.items()}


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_reference(arch, use_pallas):
    kw = {"use_pallas": use_pallas}
    if use_pallas:
        kw["attn_impl"] = "flash"   # reach the flash kernel at S <= 1024
    jcfg, cfg = configs(arch, **kw)
    jparams, params = shared_params(cfg, 1)
    B, S_total, S_prompt = 2, 12, 5
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (B, S_total)).astype(np.int32)
    src = {}
    if cfg.is_encdec:       # encoder frames go with the forward and prefill
        src["enc_embeds"] = (rng.standard_normal((B, SRC_LEN, cfg.d_model))
                             * 0.1).astype(np.float32)
    jforward = jax.jit(lambda p, b: JM.forward(jcfg, p, b, mode="train"))
    jprefill = jax.jit(lambda p, b, c: JM.prefill(jcfg, p, b, c))
    jdecode = jax.jit(lambda p, b, c: JM.decode_step(jcfg, p, b, c))
    jl, _, _ = jforward(jparams, jbatch(tokens=toks, **src))
    with torch.no_grad():
        tl, _, _ = M.forward(cfg, params, tbatch(tokens=toks, **src),
                             mode="train")
    assert scale_err(jl, tl) < 1e-4

    src_len = SRC_LEN if cfg.is_encdec else 0
    jc = jax_init_params(jax.random.PRNGKey(0), JM.cache_specs_tree(
        jcfg, B, S_total, src_len=src_len))
    tc = init_params(0, M.cache_specs_tree(cfg, B, S_total, src_len=src_len),
                     device="cpu")
    assert leaves(jc).keys() == leaves(tc).keys()
    jlast, jc = jprefill(jparams, jbatch(tokens=toks[:, :S_prompt], **src),
                         jc)
    with torch.no_grad():
        tlast, tc = M.prefill(cfg, params,
                              tbatch(tokens=toks[:, :S_prompt], **src), tc)
    assert scale_err(jlast, tlast) < 1e-4
    assert scale_err(jl[:, S_prompt - 1], tlast) < TOL
    jleaves, tleaves = leaves(jc), leaves(tc)
    assert jleaves.keys() == tleaves.keys()
    for name, ref in jleaves.items():
        got = tleaves[name]
        assert tuple(got.shape) == tuple(ref.shape), name
        assert float(np.max(np.abs(np.asarray(ref, np.float32)
                                   - got.float().numpy()))) <= \
            1e-4 * max(1.0, float(np.max(np.abs(ref)))), name
    for i in range(S_prompt, S_prompt + 7):
        step = toks[:, i:i + 1]
        jlg, jc = jdecode(jparams, {"tokens": jnp.asarray(step)}, jc)
        with torch.no_grad():
            tlg, tc = M.decode_step(cfg, params,
                                    {"tokens": torch.from_numpy(step)}, tc)
        assert scale_err(jlg, tlg) < 1e-4
        assert scale_err(jl[:, i], tlg) < TOL
    assert np.array_equal(np.asarray(jc["index"]), tc["index"].numpy())


def test_prefill_and_decode_steps_give_reference_tokens():
    """`make_prefill_step` / `make_decode_step` return (next_tok,
    new_caches) with the reference's greedy tokens."""
    jcfg, cfg = configs("zamba2-7b")
    jparams, params = shared_params(cfg, 3)
    B, S = 2, 7
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                             (B, S)).astype(np.int32)
    jc = jax_init_params(jax.random.PRNGKey(0),
                         JM.cache_specs_tree(jcfg, B, S + 4))
    tc = init_params(0, M.cache_specs_tree(cfg, B, S + 4), device="cpu")
    jt, jc = jax.jit(jax_prefill_step(jcfg))(
        jparams, {"tokens": jnp.asarray(toks)}, jc)
    tt, tc = make_prefill_step(cfg)(params, {"tokens": torch.from_numpy(toks)},
                                    tc)
    assert tt.dtype == torch.int32
    assert np.array_equal(np.asarray(jt), tt.numpy())
    jdec, tdec = jax.jit(jax_decode_step(jcfg)), make_decode_step(cfg)
    for _ in range(3):
        jt, jc = jdec(jparams, {"tokens": jt[:, None]}, jc)
        tt, tc = tdec(params, {"tokens": tt[:, None]}, tc)
        assert np.array_equal(np.asarray(jt), tt.numpy())


# ------------------------------ serving ---------------------------------- #
def serving_setup():
    """The reference's `tests/test_serving.py` model, in both packages."""
    kw = dict(dtype="float32", vocab_size=128, d_model=32, num_heads=4,
              num_kv_heads=2, head_dim=8, d_ff=64)
    jcfg = jax_reduced(jax_get_config("granite-8b")).replace(**kw)
    cfg = reduced_config(get_config("granite-8b")).replace(**kw)
    jparams, params = shared_params(cfg, 0)
    return jcfg, cfg, jparams, params


def drain(eng, prompts, max_new):
    for p in prompts:
        eng.submit(p, max_new=max_new)
    objs = list(eng.queue)
    for _ in range(500):
        if not eng.queue and not eng.active:
            break
        eng.step()
    assert all(r.done for r in objs)
    return objs


def test_engine_matches_reference_engine():
    jcfg, cfg, jparams, params = serving_setup()
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size,
                           size=rng.randint(2, 9)).astype(np.int32)
               for _ in range(7)]
    jeng = JServingEngine(jcfg, jparams, JServeConfig(slots=3, max_len=64))
    teng = ServingEngine(cfg, params, ServeConfig(slots=3, max_len=64),
                         device="cpu")
    jobjs = drain(jeng, prompts, 4)
    tobjs = drain(teng, prompts, 4)
    assert [r.out_tokens for r in tobjs] == [r.out_tokens for r in jobjs]
    ju, tu = jeng.published_units(), teng.published_units()
    assert ju.keys() == tu.keys()
    for b in ju:
        assert (tu[b]["p"], tu[b]["d"]) == (ju[b]["p"], ju[b]["d"])


def greedy(cfg, params, prompt, max_new):
    """Full-forward greedy decoding without a cache
    (`tests/test_serving.py:greedy_reference`, ported)."""
    toks, out = list(map(int, prompt)), []
    with torch.no_grad():
        for _ in range(max_new):
            logits, _, _ = M.forward(cfg, params,
                                     {"tokens": torch.tensor([toks])},
                                     mode="train")
            out.append(int(torch.argmax(logits[0, -1])))
            toks.append(out[-1])
    return out


def test_engine_on_a_hybrid_model_matches_greedy():
    """More requests than slots on zamba2 (SSD + shared attention): each
    request's tokens equal its full-forward greedy decode.  The reference
    engine, on the same weights and requests, does not: its prefill
    microsteps advance the other slots' SSM states, and a refilled slot
    inherits the last request's state.  The port resets a slot's rows on
    admission and prefills on that row alone."""
    jcfg, cfg = configs("zamba2-7b")
    jparams, params = shared_params(cfg, 5)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab_size,
                           size=rng.randint(3, 7)).astype(np.int32)
               for _ in range(3)]
    want = [greedy(cfg, params, p, 4) for p in prompts]
    eng = ServingEngine(cfg, params, ServeConfig(slots=2, max_len=32),
                        device="cpu")
    assert [r.out_tokens for r in drain(eng, prompts, 4)] == want
    jeng = JServingEngine(jcfg, jparams, JServeConfig(slots=2, max_len=32))
    jtoks = [r.out_tokens for r in drain(jeng, prompts, 4)]
    assert all(t != w for t, w in zip(jtoks, want)), jtoks


# ---------------------------- weights ------------------------------------ #
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_trees_and_counts_match_reference(arch):
    """Every parameter name and shape (and the cache tree's) of the full
    config is the reference's, and so is the parameter count."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    jspecs = jax.tree_util.tree_map(lambda s: s.shape, JM.model_param_specs(
        jcfg), is_leaf=lambda x: isinstance(x, JParamSpec))
    ours = {p: tuple(s.shape)
            for p, s in tree_leaves_with_path(M.model_param_specs(cfg))}
    assert ours == {p: tuple(s) for p, s in tree_leaves_with_path(jspecs)}
    assert M.count_params(cfg) == JM.count_params(jcfg)
    assert M.count_params(cfg, active_only=True) == \
        JM.count_params(jcfg, active_only=True)
    jc = jax.tree_util.tree_map(
        lambda s: s.shape, JM.cache_specs_tree(jcfg, 2, 64, src_len=16),
        is_leaf=lambda x: isinstance(x, JParamSpec))
    tc = {p: tuple(s.shape) for p, s in tree_leaves_with_path(
        M.cache_specs_tree(cfg, 2, 64, src_len=16))}
    assert tc == {p: tuple(s) for p, s in tree_leaves_with_path(jc)}


def test_params_from_reference_round_trip():
    cfg = reduced_config(get_config("zamba2-7b"))
    specs = M.model_param_specs(cfg)
    tree = init_params_numpy(7, specs)
    params = params_from_reference(tree, specs, device="cpu")
    names = [p for p, _ in tree_leaves_with_path(specs)]
    got = leaves(params)
    assert list(got) == names
    assert "decoder.g0.L5.ssd.wz" in got and "shared_attn.attn.wq" in got
    for name, a in leaves(tree).items():
        assert got[name].dtype == torch.float32
        assert np.array_equal(got[name].numpy(), a), name
    bf = params_from_reference(
        jax.tree_util.tree_map(lambda a: np.asarray(jnp.asarray(
            a, jnp.bfloat16)), tree), specs, device="cpu")
    assert bf["embed"]["lm_head"].dtype == torch.bfloat16
    assert torch.equal(bf["embed"]["lm_head"],
                       params["embed"]["lm_head"].bfloat16())
    tree["decoder"]["g0"]["L0"]["ssd"]["wz"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="mis-shaped"):
        params_from_reference(tree, specs, device="cpu")
    del tree["embed"]["lm_head"]
    with pytest.raises(ValueError, match="missing"):
        params_from_reference(tree, specs, device="cpu")


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    from repro_torch.launch import serve
    cfg = reduced_config(get_config("zamba2-7b"))
    specs = M.model_param_specs(cfg)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        init_params(0, specs)
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_reference(init_params_numpy(0, specs), specs)
    params = init_params(0, specs, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(cfg, params, ServeConfig(slots=1, max_len=16))
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "zamba2-7b", "--reduced", "--requests", "1"])
    for dev in ("tpu", "meta"):
        with pytest.raises((ValueError, RuntimeError)):
            init_params(0, specs, device=dev)
    eng = ServingEngine(cfg, params, ServeConfig(slots=1, max_len=16),
                        device="cpu")
    assert drain(eng, [np.array([3, 1, 4], np.int32)], 2)[0].out_tokens
    serve.main(["--arch", "zamba2-7b", "--reduced", "--requests", "1",
                "--max-new", "2", "--slots", "1", "--device", "cpu"])


# ------------------ reference_serve.json (zamba2 full width) ------------ #
SERVE_SEED = 2024
SERVE_PROMPT = 1280        # > 1024: `auto` attention takes flash; 5 chunks
SERVE_DECODE = 8
SERVE_LOGIT_IDX = 64       # logits recorded at fixed indices per step


def serve_layers():
    """zamba2-7b at full width, depth cut to 7 layers with one
    shared-attention application: ((SSD,)*5 + (SSD+attn,)) x1, (SSD,) x1,
    as (mixer, mlp, shared_attn) triples per group."""
    ssd, ssd_attn = ("ssd", "none", False), ("ssd", "none", True)
    return [[[ssd] * 5 + [ssd_attn], 1], [[ssd], 1]]


def group_specs(groups, GroupSpec, LayerSpec):
    """A file's (mixer, mlp, shared_attn) triples per group as one
    package's `GroupSpec`s."""
    return tuple(GroupSpec(tuple(LayerSpec(*l) for l in ls), r)
                 for ls, r in groups)


def reference_weights(cfg, seed, scaled=False):
    """The numpy weights of ``seed`` as the reference's arrays, with each
    rank >= 2 leaf's sum of |w| as drawn (the card checks its own draw
    against these), then with the attention scaled (`scale_attention`)
    where ``scaled``; the numpy leaves are dropped as they are copied, so
    the host holds one copy of the weights at a time."""
    tree = init_params_numpy(seed, M.model_param_specs(cfg))
    checks = {p: float(np.sum(np.abs(a), dtype=np.float64))
              for p, a in tree_leaves_with_path(tree) if a.ndim >= 2}
    if scaled:
        scale_attention(tree)

    def move(node):
        return {k: move(node.pop(k)) if isinstance(node[k], dict)
                else jnp.asarray(node.pop(k)) for k in sorted(node)}
    return move(tree), checks


def scale_attention(tree):
    """Every attention block's wq/wk/wv to a fan-in of d_model and wo to
    one of heads*head_dim, in place (numpy; `chip_smoke.py`'s
    `condition_attention` on tensors): the reference's init rule takes the
    head count (wq/wk/wv) or head_dim (wo) as a rank-3 weight's fan-in,
    which saturates the softmax, and a deep random stack then amplifies
    f32 rounding ~15x a layer (seamless's encoder: 7e-5 of max|x| after
    one layer, 0.7 after twelve, port against reference; 1.7e-6 with the
    scaling)."""
    if {"wq", "wk", "wv", "wo"} <= tree.keys():
        for name in ("wq", "wk", "wv"):
            w = tree[name]
            w *= np.float32((w.shape[-2] / w.shape[-3]) ** 0.5)
        tree["wo"] *= np.float32((1.0 / tree["wo"].shape[-3]) ** 0.5)
        return
    for sub in tree.values():
        if isinstance(sub, dict):
            scale_attention(sub)


def reference_steps(jcfg, jparams, batch, caches, n_decode, idx):
    """The reference's prefill of ``batch``, then ``n_decode`` greedy
    decode steps each fed the previous step's token: per step the token,
    max|logit| and the logits at ``idx``."""
    steps = []
    logits, caches = JM.prefill(jcfg, jparams, batch, caches)
    for i in range(n_decode + 1):
        lg = np.asarray(logits[0], np.float32)
        steps.append({"token": int(np.argmax(lg)),
                      "max_abs": float(np.max(np.abs(lg))),
                      "values": [float(v) for v in lg[idx]]})
        print(f"step {i}: token {steps[-1]['token']} "
              f"max|logit| {steps[-1]['max_abs']:.4f}", flush=True)
        if i == n_decode:
            break
        tok = jnp.asarray([[steps[-1]["token"]]], jnp.int32)
        logits, caches = JM.decode_step(jcfg, jparams, {"tokens": tok},
                                        caches)
    return steps


def write_reference_serve(path=SERVE_FILE):
    from repro.configs.base import GroupSpec, LayerSpec
    from repro_torch.configs.base import GroupSpec as TG, LayerSpec as TL
    groups = serve_layers()
    jcfg = jax_get_config("zamba2-7b").replace(
        dtype="float32", use_pallas=False,
        groups=group_specs(groups, GroupSpec, LayerSpec))
    cfg = get_config("zamba2-7b").replace(
        dtype="float32", use_pallas=False,
        groups=group_specs(groups, TG, TL))
    jparams, checks = reference_weights(cfg, SERVE_SEED)
    rng = np.random.default_rng(SERVE_SEED)
    prompt = rng.integers(0, cfg.vocab_size, (1, SERVE_PROMPT)).astype(
        np.int32)
    idx = np.sort(rng.choice(cfg.vocab_size, SERVE_LOGIT_IDX,
                             replace=False)).astype(np.int64)
    caches = jax_init_params(jax.random.PRNGKey(0), JM.cache_specs_tree(
        jcfg, 1, SERVE_PROMPT + SERVE_DECODE))
    steps = reference_steps(jcfg, jparams, {"tokens": jnp.asarray(prompt)},
                            caches, SERVE_DECODE, idx)
    out = {
        "about": "reference package (repro), CPU, f32, use_pallas=False: "
                 "prefill of the prompt, then greedy decode steps each fed "
                 "the previous step's token; written by "
                 "tests/test_torch_models.py --write-reference-serve",
        "arch": "zamba2-7b", "groups": groups, "dtype": "float32",
        "seed": SERVE_SEED, "prompt": prompt[0].tolist(),
        "decode_steps": SERVE_DECODE, "logit_index": idx.tolist(),
        "tolerance": TOL, "weight_abs_sums": checks, "steps": steps,
    }
    Path(path).write_text(json.dumps(out) + "\n")
    print(f"wrote {path}")


# ------- reference_serve_moe.json (qwen3-moe-30b-a3b, full width) ------- #
MOE_FILE = ROOT / "src" / "repro_torch" / "reference_serve_moe.json"
MOE_LAYERS = 2             # depth cut; the width is the published one


def write_reference_serve_moe(path=MOE_FILE):
    """qwen3-moe-30b-a3b at full width, 2 layers: the prefill of a
    1280-token prompt (N > 512: the capacity rule, and drops) and 8 decode
    steps, with every MoE call's routing: per-expert counts, dropped
    assignments, and the prefill's expert ids per token."""
    from repro.configs.base import GroupSpec, LayerSpec
    from repro.models import moe as jmoe
    from repro_torch.configs.base import GroupSpec as TG, LayerSpec as TL
    groups = [[[("attn", "moe", False)], MOE_LAYERS]]
    jcfg = jax_get_config("qwen3-moe-30b-a3b").replace(
        dtype="float32", use_pallas=False,
        groups=group_specs(groups, GroupSpec, LayerSpec))
    cfg = get_config("qwen3-moe-30b-a3b").replace(
        dtype="float32", use_pallas=False,
        groups=group_specs(groups, TG, TL))
    jparams, checks = reference_weights(cfg, SERVE_SEED)
    rng = np.random.default_rng(SERVE_SEED)
    prompt = rng.integers(0, cfg.vocab_size, (1, SERVE_PROMPT)).astype(
        np.int32)
    idx = np.sort(rng.choice(cfg.vocab_size, SERVE_LOGIT_IDX,
                             replace=False)).astype(np.int64)
    caches = jax_init_params(jax.random.PRNGKey(0), JM.cache_specs_tree(
        jcfg, 1, SERVE_PROMPT + SERVE_DECODE))
    routing = []

    def record(experts, capacity):
        e = np.asarray(experts)
        counts = np.bincount(e.reshape(-1), minlength=cfg.num_experts)
        call = {"tokens": int(e.shape[0]), "capacity": int(capacity),
                "counts": counts.tolist(),
                "dropped": int(np.maximum(counts - capacity, 0).sum())}
        if e.shape[0] > 1:
            call["experts"] = np.sort(e, axis=1).tolist()
        routing.append(call)

    inner = jmoe._dispatch_compute

    def dispatch(xf, gates, experts, keepers, wi_g, wi_u, wo, capacity,
                 e_base, e_count):
        # the scan runs the layers: a callback sees each one's values
        jax.debug.callback(record, experts, capacity, ordered=True)
        return inner(xf, gates, experts, keepers, wi_g, wi_u, wo, capacity,
                     e_base, e_count)
    jmoe._dispatch_compute = dispatch
    try:
        steps = reference_steps(jcfg, jparams,
                                {"tokens": jnp.asarray(prompt)}, caches,
                                SERVE_DECODE, idx)
        jax.effects_barrier()
    finally:
        jmoe._dispatch_compute = inner
    print(f"routing: {len(routing)} calls, prefill drops "
          f"{[c['dropped'] for c in routing[:MOE_LAYERS]]}")
    out = {
        "about": "reference package (repro), CPU, f32, use_pallas=False: "
                 "prefill of the prompt, then greedy decode steps each fed "
                 "the previous step's token; routing: each MoE call in "
                 "order (prefill layers, then each decode step's), expert "
                 "ids per token sorted; written by "
                 "tests/test_torch_models.py --write-reference-serve-moe",
        "arch": "qwen3-moe-30b-a3b", "groups": groups, "dtype": "float32",
        "seed": SERVE_SEED, "prompt": prompt[0].tolist(),
        "decode_steps": SERVE_DECODE, "logit_index": idx.tolist(),
        "tolerance": TOL, "weight_abs_sums": checks, "steps": steps,
        "routing": routing,
    }
    Path(path).write_text(json.dumps(out) + "\n")
    print(f"wrote {path}")


# ---- reference_serve_encdec.json (seamless-m4t-medium, whole model) ---- #
ENCDEC_FILE = ROOT / "src" / "repro_torch" / "reference_serve_encdec.json"
ENCDEC_SRC = 1280          # encoder frames (> 1024: the encoder takes flash)
ENCDEC_PROMPT = 320        # target prompt


def write_reference_serve_encdec(path=ENCDEC_FILE):
    """seamless-m4t-medium whole (12 + 12 layers): the prefill of 1280
    encoder frames and a 320-token target prompt, then 8 decode steps, on
    the seed's weights with every attention block scaled to its true
    fan-in (`scale_attention`: under the init rule as it is, 36 attention
    layers make the random model chaotic, and no two implementations agree
    in f32).  The frames are drawn from the seed after the prompt and the
    logit indices; the file keeps their sum of |x| so a reader can check
    its own draw."""
    jcfg = jax_get_config("seamless-m4t-medium").replace(
        dtype="float32", use_pallas=False)
    cfg = get_config("seamless-m4t-medium").replace(dtype="float32",
                                                    use_pallas=False)
    jparams, checks = reference_weights(cfg, SERVE_SEED, scaled=True)
    rng = np.random.default_rng(SERVE_SEED)
    prompt = rng.integers(0, cfg.vocab_size, (1, ENCDEC_PROMPT)).astype(
        np.int32)
    idx = np.sort(rng.choice(cfg.vocab_size, SERVE_LOGIT_IDX,
                             replace=False)).astype(np.int64)
    frames = rng.standard_normal((1, ENCDEC_SRC, cfg.d_model),
                                 dtype=np.float32)
    caches = jax_init_params(jax.random.PRNGKey(0), JM.cache_specs_tree(
        jcfg, 1, ENCDEC_PROMPT + SERVE_DECODE, src_len=ENCDEC_SRC))
    steps = reference_steps(jcfg, jparams, {
        "tokens": jnp.asarray(prompt), "enc_embeds": jnp.asarray(frames)},
        caches, SERVE_DECODE, idx)
    out = {
        "about": "reference package (repro), CPU, f32, use_pallas=False: "
                 "prefill of the encoder frames and the target prompt, "
                 "then greedy decode steps each fed the previous step's "
                 "token; weights drawn from the seed (weight_abs_sums: as "
                 "drawn), then every attention block's wq/wk/wv scaled by "
                 "sqrt(heads / d_model) and wo by sqrt(1 / heads) "
                 "(attention_scaled); frames = default_rng(seed) standard "
                 "normal "
                 "(1, src_len, d_model) f32, drawn after the prompt and "
                 "the logit index; written by tests/test_torch_models.py "
                 "--write-reference-serve-encdec",
        "arch": "seamless-m4t-medium", "groups": None, "dtype": "float32",
        "attention_scaled": True,
        "seed": SERVE_SEED, "prompt": prompt[0].tolist(),
        "src_len": ENCDEC_SRC,
        "frames_abs_sum": float(np.sum(np.abs(frames), dtype=np.float64)),
        "decode_steps": SERVE_DECODE, "logit_index": idx.tolist(),
        "tolerance": TOL, "weight_abs_sums": checks, "steps": steps,
    }
    Path(path).write_text(json.dumps(out) + "\n")
    print(f"wrote {path}")


if __name__ == "__main__":
    writers = {"--write-reference-serve": write_reference_serve,
               "--write-reference-serve-moe": write_reference_serve_moe,
               "--write-reference-serve-encdec": write_reference_serve_encdec}
    chosen = [w for flag, w in writers.items() if flag in sys.argv]
    for write in chosen:
        write()
    if not chosen:
        sys.exit(pytest.main([__file__, "-q"]))
