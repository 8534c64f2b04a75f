"""How far bf16 rounding moves zamba2's whole-model gradient, in the
reference and in the port, on the CPU.

zamba2-7b with its published SSD and attention head shapes, d_model cut,
the layer pattern of the train cut in `chip_smoke.py` (13 layers:
`(SSD x5, SSD + shared attention) x2 + SSD`) or its first layers, the
shared attention scaled to a fan-in of d_model as `chip_smoke.py` scales
it, random weights from a seed.  For one batch it takes the gradient of
the loss in f32 and in bf16 (f32 masters cast inside the gradient, as the
train steps cast them): `jax.grad` of the reference's `loss_fn`, and the
port's `loss_and_grads` through the plain torch paths and through its
kernels' plain versions (`use_pallas`).  The SSD chunk is 64: at the
published 256 the reference's f32 gradient is NaN (its masked
`exp(segsum)`, ROADMAP queue 3).

The test holds the port's bf16 gradient no farther from the reference's
f32 gradient than the reference's own bf16 gradient is (1.5x over all
leaves), at two layers.  Run as a script, it prints the spread by depth:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_bf16_spread.py \\
        [--d-model 512] [--d-ff 2048] [--seq 512] [--layers 2 6 13]
"""
import argparse

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import GroupSpec as JGroup  # noqa: E402
from repro.configs.base import LayerSpec as JLayer  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.models import model as jax_model  # noqa: E402

from repro_torch.configs.base import GroupSpec, LayerSpec  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.parallel.sharding import (init_params_numpy,  # noqa: E402
                                           tree_leaves_with_path)
from repro_torch.training.train_state import loss_and_grads  # noqa: E402


def groups(group, layer, n_layers):
    """The train cut's pattern (13 layers), or its first ``n_layers``
    ending in a shared-attention hit."""
    ssd = layer(mixer="ssd", mlp="none")
    hit = layer(mixer="ssd", mlp="none", shared_attn=True)
    if n_layers == 13:
        return (group((ssd,) * 5 + (hit,), 2), group((ssd,), 1))
    return (group((ssd,) * (n_layers - 1) + (hit,), 1),)


def rel_l2(got, want):
    """(per-leaf relative L2, over all leaves at once)."""
    per = {k: np.linalg.norm(got[k] - w) / max(np.linalg.norm(w), 1e-30)
           for k, w in want.items()}
    num = sum(np.sum((got[k] - w) ** 2) for k, w in want.items())
    den = sum(np.sum(w ** 2) for w in want.values())
    return per, float(np.sqrt(num / den))


def spread(d_model, d_ff, seq, n_layers, vocab=32000, batch=2, seed=17):
    """Over all leaves: the reference's bf16 gradient against its f32 one,
    the port's plain bf16 gradient against the reference's f32 one, the
    port's kernel route (plain versions) against its plain route in bf16,
    and the port's f32 against the reference's f32; with each one's worst
    leaf."""
    kw = dict(d_model=d_model, d_ff=d_ff, vocab_size=vocab, dtype="float32",
              remat="none", ssd_chunk=64)
    jcfg = jax_get_config("zamba2-7b").replace(
        **kw, groups=groups(JGroup, JLayer, n_layers))
    cfg = get_config("zamba2-7b").replace(
        **kw, groups=groups(GroupSpec, LayerSpec, n_layers))
    specs = M.model_param_specs(cfg)
    tree = init_params_numpy(seed, specs)
    attn, heads = tree["shared_attn"]["attn"], cfg.shared_attn_heads
    for name in ("wq", "wk", "wv"):
        attn[name] *= np.float32((heads / d_model) ** 0.5)
    attn["wo"] *= np.float32((1.0 / heads) ** 0.5)
    toks = np.random.default_rng(0).integers(
        0, vocab, (batch, seq + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def ref_grads(dtype):
        c = jcfg.replace(dtype=dtype)

        def lf(p):
            half = jax.tree_util.tree_map(
                lambda x: x.astype(c.act_dtype)
                if x.dtype == jnp.float32 and x.ndim >= 2 else x, p)
            return jax_model.loss_fn(
                c, half, {k: jnp.asarray(v) for k, v in b.items()})[0]
        g = jax.jit(jax.grad(lf))(jax.tree_util.tree_map(jnp.asarray, tree))
        return {p: np.asarray(x, np.float64)
                for p, x in tree_leaves_with_path(jax.device_get(g))}

    def port_grads(dtype, use_pallas=False):
        c = cfg.replace(dtype=dtype, use_pallas=use_pallas)
        _, g = loss_and_grads(c, params_from_reference(tree, specs,
                                                       device="cpu"),
                              {k: torch.from_numpy(v) for k, v in b.items()})
        return {p: x.double().numpy() for p, x in tree_leaves_with_path(g)}

    r32, r16 = ref_grads("float32"), ref_grads("bfloat16")
    p32, p16 = port_grads("float32"), port_grads("bfloat16")
    k16 = port_grads("bfloat16", use_pallas=True)
    out = {}
    for name, got, want in (("ref_bf16_vs_ref_f32", r16, r32),
                            ("port_bf16_vs_ref_f32", p16, r32),
                            ("port_kernels_vs_plain_bf16", k16, p16),
                            ("port_f32_vs_ref_f32", p32, r32)):
        per, total = rel_l2(got, want)
        worst = max(per, key=per.get)
        out[name] = (total, worst, float(per[worst]))
    return out


def test_port_bf16_gradients_no_noisier_than_reference():
    """Two layers (SSD, SSD + shared attention) at d_model 64: the port's
    plain bf16 gradient lies within 1.5x the reference's own bf16-vs-f32
    distance of the reference's f32 gradient, its kernel route within
    that distance of its plain route, and its f32 gradient within 1e-5."""
    s = spread(d_model=64, d_ff=256, seq=128, n_layers=2, vocab=512)
    ref = s["ref_bf16_vs_ref_f32"][0]
    assert 0 < ref < 0.2, s
    assert s["port_bf16_vs_ref_f32"][0] <= 1.5 * ref, s
    assert s["port_kernels_vs_plain_bf16"][0] <= ref, s
    assert s["port_f32_vs_ref_f32"][0] <= 1e-5, s


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--d-ff", type=int, default=2048)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 6, 13])
    a = ap.parse_args()
    for n in a.layers:
        s = spread(a.d_model, a.d_ff, a.seq, n)
        print(f"d_model {a.d_model} d_ff {a.d_ff} seq {a.seq} layers {n}: "
              + "; ".join(f"{k} {t:.4g} (worst {w} {e:.4g})"
                          for k, (t, w, e) in s.items()), flush=True)


if __name__ == "__main__":
    main()
