"""The port's encoder-decoder path against the reference package on the
CPU: `cross_attention_block` on each of its three routes, `encode_cross_kv`,
`encode`, and seamless-m4t-medium (reduced) served through the prefill and
decode steps, with inputs drawn by numpy and handed to both packages.

Tolerances, all f32: blocks within 1e-5 of their largest magnitude; the
encoder stack and the logits within 1e-4 of the reference's (the bound
`tests/test_torch_models.py` holds whole models to) and within 2e-3 of the
model's own full forward (the reference's
`test_prefill_decode_matches_forward`); greedy tokens equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.base import reduced_config as jax_reduced  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.parallel.sharding import init_params as jax_init_params  # noqa: E402
from repro.training.train_state import \
    make_decode_step as jax_decode_step  # noqa: E402
from repro.training.train_state import \
    make_prefill_step as jax_prefill_step  # noqa: E402

from repro_torch.configs.base import get_config, reduced_config  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.parallel.sharding import (init_params,  # noqa: E402
                                           init_params_numpy,
                                           tree_leaves_with_path)
from repro_torch.training.train_state import (make_decode_step,  # noqa: E402
                                              make_prefill_step)

ARCH = "seamless-m4t-medium"
REL = 1e-5


def rel_err(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    got = got.detach().double().numpy()
    return float(np.max(np.abs(ref - got))) / max(
        float(np.max(np.abs(ref))), 1e-30)


def t(a):
    return torch.from_numpy(np.array(a))


def cfgs(**kw):
    kw = dict(dtype="float32", **kw)
    return (jax_reduced(jax_get_config(ARCH)).replace(**kw),
            reduced_config(get_config(ARCH)).replace(**kw))


def shared(cfg, specs, seed):
    tree = init_params_numpy(seed, specs)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_reference(tree, specs, device="cpu"))


def frames(cfg, B, S, seed, scale=0.1):
    return (np.random.default_rng(seed).standard_normal((B, S, cfg.d_model))
            * scale).astype(np.float32)


# the three routes of `cross_attention_block`: one query per sequence; full
# scores while Sq * S_src <= 4096^2; the brick scan above (with bricks of
# 1024 x 2048, so the 4096 x 4097 case takes 12 of them)
@pytest.mark.parametrize("Sq,S_src,chunks", [(1, 24, None), (12, 24, None),
                                             (4096, 4097, (1024, 2048))])
def test_cross_attention_block_matches_reference(Sq, S_src, chunks):
    kw = {} if chunks is None else dict(attn_chunk_q=chunks[0],
                                        attn_chunk_kv=chunks[1])
    jcfg, cfg = cfgs(**kw)
    jp, tp = shared(cfg, A.cross_attn_specs(cfg), 1)
    B = 2 if Sq < 4096 else 1
    x = frames(cfg, B, Sq, 2, 1.0)
    enc = frames(cfg, B, S_src, 3, 1.0)
    jkv = JA.encode_cross_kv(jp, jnp.asarray(enc), jcfg)
    kv = A.encode_cross_kv(tp, t(enc), cfg)
    for a, b in zip(jkv, kv):
        assert rel_err(a, b) < REL
    ref = JA.cross_attention_block(jp, jnp.asarray(x), jkv, jcfg)
    got = A.cross_attention_block(tp, t(x), kv, cfg)
    assert got.shape == (B, Sq, cfg.d_model)
    assert rel_err(ref, got) < REL


def test_encode_matches_reference():
    jcfg, cfg = cfgs()
    jp, tp = shared(cfg, M.model_param_specs(cfg), 4)
    enc = frames(cfg, 2, 20, 5)
    ref = JM.encode(jcfg, jp, {"enc_embeds": jnp.asarray(enc)})
    got = M.encode(cfg, tp, {"enc_embeds": t(enc)})
    assert got.shape == (2, 20, cfg.d_model)
    assert rel_err(ref, got) < 1e-4


def test_encode_is_bidirectional():
    """A change to the last frame moves every encoder position."""
    _, cfg = cfgs()
    _, tp = shared(cfg, M.model_param_specs(cfg), 4)
    enc = frames(cfg, 1, 10, 6)
    a = M.encode(cfg, tp, {"enc_embeds": t(enc)})
    enc[:, -1] += 1.0
    b = M.encode(cfg, tp, {"enc_embeds": t(enc)})
    assert bool(((a - b).abs().amax(dim=-1) > 0).all())


@pytest.mark.parametrize("use_pallas", [False, True])
def test_serve_steps_match_reference_and_forward(use_pallas):
    """Prefill (20 encoder frames, a 5-token target prompt) and 6 greedy
    decode steps through `make_prefill_step` / `make_decode_step`: the
    cross caches equal the reference's, the tokens equal its steps', and
    every step's logits equal the port's own full forward over the
    sequence so far.  With ``use_pallas`` the encoder's attention takes the
    flash route (the kernel's plain version here)."""
    kw = dict(use_pallas=True, attn_impl="flash") if use_pallas else {}
    jcfg, cfg = cfgs(**kw)
    jp, tp = shared(cfg, M.model_param_specs(cfg), 7)
    B, S_src, S_prompt, n_dec = 2, 20, 5, 6
    enc = frames(cfg, B, S_src, 8)
    prompt = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (B, S_prompt)).astype(np.int32)
    cache_len = S_prompt + n_dec
    jc = jax_init_params(jax.random.PRNGKey(0), JM.cache_specs_tree(
        jcfg, B, cache_len, src_len=S_src))
    tc = init_params(0, M.cache_specs_tree(cfg, B, cache_len, src_len=S_src),
                     device="cpu")
    jt, jc = jax.jit(jax_prefill_step(jcfg))(
        jp, {"tokens": jnp.asarray(prompt), "enc_embeds": jnp.asarray(enc)},
        jc)
    tt, tc = make_prefill_step(cfg)(
        tp, {"tokens": t(prompt), "enc_embeds": t(enc)}, tc)
    want = dict(tree_leaves_with_path(jax.device_get(jc)))
    got = dict(tree_leaves_with_path(tc))
    assert got.keys() == want.keys()
    assert any(p.endswith("cross_k") for p in got)
    for path, a in want.items():
        assert got[path].shape == a.shape, path
        if np.any(a):
            assert rel_err(a, got[path]) < 1e-4, path
    seq = [prompt]
    jdec, tdec = jax.jit(jax_decode_step(jcfg)), make_decode_step(cfg)
    for _ in range(n_dec):
        assert np.array_equal(np.asarray(jt), tt.numpy())
        seq.append(tt.numpy()[:, None])
        with torch.no_grad():
            full, _, _ = M.forward(cfg, tp, {"tokens": t(np.concatenate(
                seq, 1)), "enc_embeds": t(enc)}, mode="train")
        want_tok = full[:, -1].argmax(-1).to(torch.int32)
        jt, jc = jdec(jp, {"tokens": jt[:, None]}, jc)
        tt, tc = tdec(tp, {"tokens": tt[:, None]}, tc)
        assert torch.equal(tt, want_tok)
    assert np.array_equal(np.asarray(jt), tt.numpy())
    assert np.array_equal(np.asarray(jc["index"]), tc["index"].numpy())


def test_prefill_decode_logits_match_forward():
    """The reference's `test_prefill_decode_matches_forward` for seamless,
    on the port: teacher-forced decode logits within 2e-3 of max|logit| of
    the full forward's."""
    _, cfg = cfgs()
    _, tp = shared(cfg, M.model_param_specs(cfg), 1)
    B, S_total, S_prompt, src = 2, 12, 5, 8
    rng = np.random.default_rng(2)
    toks = t(rng.integers(0, cfg.vocab_size, (B, S_total)).astype(np.int32))
    enc = t(frames(cfg, B, src, 3))
    with torch.no_grad():
        full, _, _ = M.forward(cfg, tp, {"tokens": toks, "enc_embeds": enc},
                               mode="train")
        caches = init_params(0, M.cache_specs_tree(cfg, B, S_total,
                                                   src_len=src), device="cpu")
        last, caches = M.prefill(cfg, tp, {"tokens": toks[:, :S_prompt],
                                           "enc_embeds": enc}, caches)
        errs = [float((last - full[:, S_prompt - 1]).abs().max())]
        for i in range(S_prompt, S_total):
            lg, caches = M.decode_step(cfg, tp, {"tokens": toks[:, i:i + 1]},
                                       caches)
            errs.append(float((lg - full[:, i]).abs().max()))
    assert max(errs) / float(full.abs().max()) < 2e-3, errs


def test_cross_cache_of_another_length_is_refused():
    _, cfg = cfgs()
    tp = init_params(0, M.model_param_specs(cfg), device="cpu")
    caches = init_params(0, M.cache_specs_tree(cfg, 1, 8, src_len=6),
                         device="cpu")
    batch = {"tokens": torch.zeros((1, 3), dtype=torch.int32),
             "enc_embeds": torch.zeros((1, 7, cfg.d_model))}
    with pytest.raises(ValueError, match="src_len"):
        M.prefill(cfg, tp, batch, caches)


def test_reference_init_makes_the_encoder_chaotic():
    """A fault of the reference's init rule (ROADMAP queue 3): it takes a
    rank-3 weight's shape[-2] as its fan-in, the head count of wq/wk/wv, so
    seamless's attention saturates at full width and the encoder amplifies
    rounding layer by layer.  Four full-width encoder layers move 3e-3 of
    max|x| when the reference's own weights move one ulp; with attention
    scaled to its true fan-in (as `reference_serve_encdec.json` is taken)
    they move 7e-7."""
    from repro.configs.base import GroupSpec as JG
    from repro.configs.base import LayerSpec as JL
    from repro_torch.configs.base import GroupSpec, LayerSpec
    from test_torch_models import scale_attention
    jcfg = jax_get_config(ARCH).replace(
        dtype="float32", vocab_size=256, encoder_groups=(JG((JL(),), 4),),
        groups=(JG((JL(),), 1),))
    cfg = get_config(ARCH).replace(
        dtype="float32", vocab_size=256,
        encoder_groups=(GroupSpec((LayerSpec(),), 4),),
        groups=(GroupSpec((LayerSpec(),), 1),))
    enc = jnp.asarray(frames(cfg, 1, 256, 0, 1.0))
    run = jax.jit(lambda p: JM.encode(jcfg, p, {"enc_embeds": enc}))
    spread = {}
    for scaled in (False, True):
        tree = init_params_numpy(5, M.model_param_specs(cfg))
        if scaled:
            scale_attention(tree)
        a = np.asarray(run(jax.tree_util.tree_map(jnp.asarray, tree)))
        b = np.asarray(run(jax.tree_util.tree_map(lambda w: jnp.asarray(
            np.nextafter(w, np.float32(np.inf))), tree)))
        spread[scaled] = float(np.abs(a - b).max() / np.abs(a).max())
    assert spread[False] > 1e-3, spread
    assert spread[True] < 1e-3 * spread[False], spread
