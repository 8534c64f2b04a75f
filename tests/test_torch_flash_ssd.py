"""The port's attention and SSD kernels' plain versions against the reference
package on the CPU: FlashAttention (brick scan, the kernel's plain version)
against `mha_reference`, the reference's brick scan and its Pallas kernel in
interpret mode; the SSD scan (chunked torch scan, the kernel's plain
version) against `ssd_naive`, `ssd_scan` and `ssd_pallas` in interpret
mode.  Inputs come from numpy seeds and are handed to both packages;
tolerances are the reference's own (`tests/test_kernels.py`)."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import flash_fwd_pallas  # noqa: E402
from repro.kernels.flash_attention.ops import _flash_fwd_jnp  # noqa: E402
from repro.kernels.flash_attention.ref import mha_reference  # noqa: E402
from repro.kernels.ssd.kernel import ssd_pallas  # noqa: E402
from repro.kernels.ssd.ref import ssd_naive as jax_ssd_naive  # noqa: E402
from repro.models.ssm import ssd_scan as jax_ssd_scan  # noqa: E402

from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    brick_fwd, flash_attention)
from repro_torch.kernels.flash_attention.ref import \
    mha_reference as port_mha  # noqa: E402
from repro_torch.kernels.ssd import kernel as sk  # noqa: E402
from repro_torch.kernels.ssd.ops import ssd as port_ssd_op  # noqa: E402
from repro_torch.kernels.ssd.ref import ssd_naive  # noqa: E402
from repro_torch.models.ssm import ssd_scan  # noqa: E402

FLASH_CASES = [
    # B, Sq, Skv, Hq, Hkv, D, causal, window
    (2, 128, 128, 4, 2, 32, True, 0),
    (1, 100, 100, 4, 4, 16, True, 0),       # ragged seq
    (2, 128, 128, 8, 2, 32, True, 24),      # sliding window
    (2, 64, 128, 4, 2, 16, False, 0),       # cross attention
    (1, 256, 256, 2, 1, 64, True, 0),
]
SSD_CASES = [
    # B, S, H, P, G, N, chunk
    (2, 64, 4, 16, 1, 16, 16),
    (1, 96, 2, 32, 1, 8, 32),
    (2, 128, 4, 16, 2, 16, 64),
    (1, 50, 2, 16, 1, 16, 16),   # ragged
]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def both(a, dtype="float32"):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(np.asarray(a)).to(td)


def err(jx, tx):
    return float(np.max(np.abs(np.asarray(jx, np.float32)
                               - tx.float().numpy())))


def flash_inputs(case, dtype, seed):
    B, Sq, Skv, Hq, Hkv, D, _, _ = case
    rs = np.random.default_rng(seed)
    return [both(rs.standard_normal(s).astype(np.float32), dtype)
            for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D))]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_brick_scan_matches_reference(case, dtype):
    """The port's brick scan (out and lse) against the reference's jnp
    brick scan and `mha_reference`, at the reference's tolerances."""
    B, Sq, Skv, Hq, Hkv, D, causal, window = case
    (jq, tq), (jk, tk), (jv, tv) = flash_inputs(case, dtype, 0)
    tol = 2e-6 if dtype == "float32" else 2e-2
    out = flash_attention(tq, tk, tv, causal, window, 32, 32, "jnp")
    assert out.dtype == tq.dtype and out.shape == tq.shape
    assert err(mha_reference(jq, jk, jv, causal=causal, window=window),
               out) < tol
    jout, jlse = _flash_fwd_jnp(jq, jk, jv, causal, window, 32, 32)
    assert err(jout, out) < tol
    assert err(port_mha(tq, tk, tv, causal=causal, window=window).float(),
               out) < tol
    out2, lse = brick_fwd(tq, tk, tv, causal, window, 32, 32)
    assert torch.equal(out2, out)
    assert lse.shape == (B, Sq, Hq) and lse.dtype == torch.float32
    assert err(jnp.reshape(jlse, (B, Sq, Hq)), lse) < 1e-4


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_plain_matches_pallas(case, dtype):
    """The CUDA kernel's plain version (what `flash_fwd` runs for CPU
    tensors) against the Pallas kernel in interpret mode: out and lse."""
    B, Sq, Skv, Hq, Hkv, D, causal, window = case
    (jq, tq), (jk, tk), (jv, tv) = flash_inputs(case, dtype, 1)
    n0 = dict(fk.LAUNCHES)
    out, lse = fk.flash_fwd(tq, tk, tv, causal=causal, window=window)
    assert fk.LAUNCHES == n0        # CPU tensors never launch
    jout, jlse = flash_fwd_pallas(jq, jk, jv, causal=causal, window=window,
                                  block_q=64, block_k=64)
    tol = 2e-5 if dtype == "float32" else 2e-2
    assert out.dtype == tq.dtype
    assert err(jout, out) < tol
    assert err(jlse, lse) < (1e-4 if dtype == "float32" else 2e-2)
    assert torch.isfinite(lse).all()
    # through the autograd Function with impl="pallas"
    out2 = flash_attention(tq, tk, tv, causal, window, 64, 64, "pallas")
    assert torch.equal(out2, out)


def test_flash_backward_matches_mha_reference():
    """Through either forward the flash backward gives `mha_reference`'s
    gradients (`tests/test_torch_training.py` holds it to `jax.grad`)."""
    rs = np.random.default_rng(5)
    ins = [rs.standard_normal((1, 24, 2, 8)).astype(np.float32)
           for _ in range(3)]
    want = None
    for impl in ("jnp", "pallas", "ref"):
        q, k, v = (torch.from_numpy(a).requires_grad_() for a in ins)
        out = (port_mha(q, k, v, causal=True) if impl == "ref" else
               flash_attention(q, k, v, True, 0, 8, 8, impl))
        grads = torch.autograd.grad(out.sin().sum(), (q, k, v))
        if want is None:
            want = grads
            continue
        for a, b in zip(grads, want):
            assert float((a - b).abs().max()) < 2e-5, impl


def ssd_inputs(case, seed):
    B, S, H, P, G, N, _ = case
    rs = np.random.default_rng(seed)
    x = rs.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.logaddexp(rs.standard_normal((B, S, H)), 0).astype(np.float32)
    A = (-np.exp(rs.standard_normal(H) * 0.3)).astype(np.float32)
    Bm = (rs.standard_normal((B, S, G, N)) * 0.5).astype(np.float32)
    Cm = (rs.standard_normal((B, S, G, N)) * 0.5).astype(np.float32)
    return [both(a) for a in (x, dt, A, Bm, Cm)]


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_scan_and_kernel_plain_match_reference(case):
    chunk = case[-1]
    pairs = ssd_inputs(case, 0)
    jargs = [j for j, _ in pairs]
    targs = [t for _, t in pairs]
    y0, s0 = jax_ssd_naive(*jargs)
    refs = [(y0, s0), jax_ssd_scan(*jargs, chunk=chunk),
            ssd_pallas(*jargs, chunk=chunk)]
    n0 = dict(sk.LAUNCHES)
    ours = [ssd_naive(*targs), ssd_scan(*targs, chunk=chunk),
            sk.ssd_scan(*targs, chunk=chunk),
            port_ssd_op(*targs, chunk=chunk, impl="pallas"),
            port_ssd_op(*targs, chunk=chunk, impl="torch")]
    assert sk.LAUNCHES == n0
    for y, s in ours:
        assert y.shape == targs[0].shape and s.dtype == torch.float32
        for jy, js in refs:
            assert err(jy, y) < 1e-3
            assert err(js, s) < 1e-3


def test_ssd_decode_step_matches_scan():
    """Single-token recurrence == the quadratic form, step by step."""
    B, S, H, P, G, N = 1, 12, 2, 8, 1, 8
    x, dt, A, Bm, Cm = ssd_inputs((B, S, H, P, G, N, 16), 3)
    y_ref, final_ref = jax_ssd_naive(x[0], dt[0], A[0], Bm[0], Cm[0])
    x, dt, A, Bm, Cm = (t for _, t in (x, dt, A, Bm, Cm))
    st = torch.zeros((B, H, P, N))
    Bh = Bm.repeat_interleave(H // G, 2)
    Ch = Cm.repeat_interleave(H // G, 2)
    ys = []
    for t in range(S):
        dA = torch.exp(dt[:, t] * A)
        upd = torch.einsum("bh,bhp,bhn->bhpn", dt[:, t], x[:, t], Bh[:, t])
        st = st * dA[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", st, Ch[:, t]))
    assert err(y_ref, torch.stack(ys, 1)) < 1e-4
    assert err(final_ref, st) < 1e-4


def test_ssd_init_state_threading():
    """Chunked scan with init state == one long scan split in two, and
    both equal the reference's scan and its naive form with init state."""
    B, S, H, P, G, N = 1, 64, 2, 8, 1, 8
    pairs = ssd_inputs((B, S, H, P, G, N, 16), 4)
    x, dt, A, Bm, Cm = (t for _, t in pairs)
    y_all, s_all = ssd_scan(x, dt, A, Bm, Cm, chunk=16)
    jy, js = jax_ssd_scan(*(j for j, _ in pairs), chunk=16)
    assert err(jy, y_all) < 1e-4 and err(js, s_all) < 1e-4
    half = S // 2
    y1, s1 = ssd_scan(x[:, :half], dt[:, :half], A, Bm[:, :half],
                      Cm[:, :half], chunk=16)
    y2, s2 = ssd_scan(x[:, half:], dt[:, half:], A, Bm[:, half:],
                      Cm[:, half:], chunk=16, init_state=s1)
    assert float((torch.cat([y1, y2], 1) - y_all).abs().max()) < 1e-4
    assert float((s2 - s_all).abs().max()) < 1e-4
    y2n, s2n = ssd_naive(x[:, half:], dt[:, half:], A, Bm[:, half:],
                         Cm[:, half:], init_state=s1)
    assert float((y2n - y2).abs().max()) < 1e-4
    assert float((s2n - s2).abs().max()) < 1e-4


def test_ssd_kernel_plain_keeps_bf16_output_dtype():
    pairs = ssd_inputs((1, 40, 2, 16, 1, 16, 16), 5)
    x, dt, A, Bm, Cm = (t for _, t in pairs)
    y, s = sk.ssd_scan(x.bfloat16(), dt, A, Bm.bfloat16(), Cm.bfloat16(),
                       chunk=16)
    y32, s32 = sk.ssd_scan(x.bfloat16().float(), dt, A,
                           Bm.bfloat16().float(), Cm.bfloat16().float(),
                           chunk=16)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    assert torch.equal(s, s32)
    assert float((y.float() - y32).abs().max()) <= \
        float(y32.abs().max()) * 2 ** -8


def test_launchers_take_only_cuda_tensors():
    """The launch half of each wrapper refuses CPU tensors; only the public
    function routes a CPU tensor to the plain version.  A meta tensor
    takes the custom op's fake (outputs of the right shape, no launch);
    any other device, and mixed devices, raise."""
    q = torch.zeros((1, 4, 2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        fk._launch_flash_fwd(q, q, q, True, 0)
    with pytest.raises(ValueError, match="CUDA"):
        fk.flash_fwd_v1(q, q, q)
    x = torch.zeros((1, 4, 2, 8))
    dt = torch.zeros((1, 4, 2))
    bc = torch.zeros((1, 4, 1, 8))
    with pytest.raises(ValueError, match="CUDA"):
        sk._launch_ssd_scan(x, dt, torch.zeros(2), bc, bc, 4)
    with pytest.raises(ValueError, match="CUDA"):
        sk.ssd_scan_v1(x, dt, torch.zeros(2), bc, bc, 4)
    meta = torch.zeros((1, 4, 2, 8), device="meta")
    before = (dict(fk.LAUNCHES), dict(sk.LAUNCHES))
    out, lse = fk.flash_fwd(meta, meta, meta)
    assert (out.device.type, out.shape, lse.shape) == (
        "meta", meta.shape, (1, 4, 2))
    assert (dict(fk.LAUNCHES), dict(sk.LAUNCHES)) == before
    other = types.SimpleNamespace(device=torch.device("xla"))
    with pytest.raises(ValueError, match="unsupported device"):
        fk.flash_fwd(other, other, other)
    with pytest.raises(ValueError, match="unsupported device"):
        sk.ssd_scan(other, other, other, other, other)
    with pytest.raises(ValueError, match="mixed devices"):
        sk.ssd_scan(meta, dt, torch.zeros(2), bc, bc)


def _tf32(t):
    """f32 rounded to nearest tf32 (10 mantissa bits, ties away from zero),
    as cvt.rna.tf32.f32 rounds it."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _ssd_scan_mma_emulated(x, dt, A, Bm, Cm, chunk):
    """The tensor-core SSD kernel's chunk arithmetic (csrc/ssd_scan_mma.cu)
    at its rounding points: C B^T exact in f32 from 16-bit inputs, M =
    (C B^T) exp(cum_i - cum_j) dt_j rounded to x's dtype, the state as an
    operand of C state^T and the decay-scaled x of the state update
    rounded to tf32, everything else f32; y rounded to x's dtype."""
    S, H = x.shape[1], x.shape[2]
    rep = H // Bm.shape[2]
    Bh = Bm.repeat_interleave(rep, 2).float()
    Ch = Cm.repeat_interleave(rep, 2).float()
    xf = x.float()
    st = torch.zeros(x.shape[0], H, x.shape[3], Bm.shape[3])
    ys = []
    for t0 in range(0, S, chunk):
        sl = slice(t0, min(S, t0 + chunk))
        d = dt[:, sl]
        cum = torch.cumsum(d * A, 1)                             # (B,L,H)
        Lc = cum.shape[1]
        cb = torch.einsum("bihn,bjhn->bhij", Ch[:, sl], Bh[:, sl])
        ct = cum.permute(0, 2, 1)
        m = cb * torch.exp(ct[..., :, None] - ct[..., None, :]) \
            * d.permute(0, 2, 1)[..., None, :]
        m = torch.where(torch.tril(torch.ones(Lc, Lc, dtype=torch.bool)), m,
                        torch.zeros(()))
        m = m.to(x.dtype).float()
        y = torch.einsum("bhij,bjhp->bihp", m, xf[:, sl])
        y = y + torch.einsum("bihn,bhpn->bihp", Ch[:, sl], _tf32(st)) \
            * torch.exp(cum)[..., None]
        ys.append(y)
        w = d * torch.exp(cum[:, -1:] - cum)
        st = st * torch.exp(cum[:, -1])[..., None, None] + torch.einsum(
            "bjhp,bjhn->bhpn", _tf32(w[..., None] * xf[:, sl]), Bh[:, sl])
    return torch.cat(ys, 1).to(x.dtype), st


def test_ssd_mma_rounding_points_stay_within_bound():
    """The tensor-core route's documented rounding points (bf16 M, tf32
    state and decay-scaled x) keep the scan within the card tests' bound,
    1e-2 of max|y| and of max|state|, of the reference's f32 quadratic
    form on the same bf16 inputs."""
    B, S, H, P, G, N, chunk = 1, 1024, 4, 64, 1, 64, 256
    rs = np.random.default_rng(13)
    x = rs.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.logaddexp(rs.standard_normal((B, S, H)), 0).astype(np.float32)
    A = (-np.exp(rs.standard_normal(H) * 0.3)).astype(np.float32)
    Bm = (rs.standard_normal((B, S, G, N)) * 0.5).astype(np.float32)
    Cm = (rs.standard_normal((B, S, G, N)) * 0.5).astype(np.float32)
    xb, Bb, Cb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, Bm, Cm))
    jy, js = jax_ssd_naive(*(jnp.asarray(a) for a in (
        xb.float().numpy(), dt, A, Bb.float().numpy(), Cb.float().numpy())))
    jy, js = np.asarray(jy), np.asarray(js)
    y, st = _ssd_scan_mma_emulated(xb, torch.from_numpy(dt),
                                   torch.from_numpy(A), Bb, Cb, chunk)
    assert y.dtype == torch.bfloat16
    assert np.abs(y.float().numpy() - jy).max() <= 1e-2 * np.abs(jy).max()
    assert np.abs(st.numpy() - js).max() <= 1e-2 * np.abs(js).max()
    # the rounding is there: M in bf16 moves y off the f32 chunked scan
    y32, _ = ssd_scan(xb.float(), torch.from_numpy(dt), torch.from_numpy(A),
                      Bb.float(), Cb.float(), chunk=chunk)
    assert not torch.equal(y, y32.to(torch.bfloat16))
