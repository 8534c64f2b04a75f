"""The wgmma SSD kernel's host half on the CPU (no card, no nvcc): the
route rule of `ssd_scan` (`ssd_route`, `wgmma_chunk`), the blocks of a
cluster and the states scanned across them (`cluster_walk`, and the
kernel's exchange of update rows, scan and return of entering states
played with its index arithmetic), the launch counters, the build's
sources, and the custom op's FLOP count on a meta trace.  The kernel's
arithmetic, emulated chunk by chunk as the cluster's blocks run it (the
chunk the kernel walks, rounds of 8 blocks, each chunk's entering state
the carry over the chunks before it, M and the update's scaled x rounded
to bf16, the entering state rounded to tf32 as the operand of C
state^T, the state itself carried in f32), is held against the
reference's `ssd_pallas` in interpret mode and `ssd_naive`."""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd.kernel import ssd_pallas  # noqa: E402
from repro.kernels.ssd.ref import ssd_naive as jax_ssd_naive  # noqa: E402

from repro_torch import kernels_build  # noqa: E402
from repro_torch.configs.base import get_config, list_archs  # noqa: E402
from repro_torch.kernels.ssd import kernel as sk  # noqa: E402
from repro_torch.models.ssm import ssd_scan  # noqa: E402

ALIGNED = (0, 4096, 8192, 1 << 20)  # x, Bm, Cm, y base addresses


def _tf32(t):
    """f32 rounded to nearest tf32 (10 mantissa bits, ties away from zero),
    as cvt.rna.tf32.f32 rounds it."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _v3_emulated(x, dt, A, Bm, Cm, chunk):
    """csrc/ssd_scan_wgmma.cu's arithmetic.  The kernel walks chunks of
    `wgmma_chunk(S, min(chunk, S))` rows; the blocks of a (batch, head)
    cluster (`cluster_walk`) take them in rounds and each chunk starts from
    the state the block of chunk c - 1 handed it.  Per chunk: the update
    bf16(dt exp(cum_L - cum) x)^T B, state_out = state_in exp(cum_L) +
    update in f32; y = bf16(M) x + (C tf32(state_in)^T) exp(cum), rounded
    to x's dtype.  With f32 inputs no point rounds: they stand in for the
    exact products of bf16 ones.  Returns (y, final_state f32)."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    low = x.dtype == torch.bfloat16
    r16 = (lambda t: t.to(torch.bfloat16).float()) if low else (lambda t: t)
    rtf = _tf32 if low else (lambda t: t)
    L = sk.wgmma_chunk(S, min(chunk, S))
    n_chunks = -(-S // L)
    CL, walk = sk.cluster_walk(n_chunks)
    rep = H // G
    Bh = Bm.repeat_interleave(rep, 2).float()
    Ch = Cm.repeat_interleave(rep, 2).float()
    xf = x.float()
    y = torch.zeros(Bsz, S, H, P)
    handed = {}          # chunk -> the state its block pushed
    fin = None
    for k in range(max(len(w) for w in walk)):
        for r in range(CL):
            if k >= len(walk[r]):
                continue      # a slot past the last chunk
            c = walk[r][k]
            st_in = handed.pop(c - 1) if c > 0 else None
            sl = slice(c * L, min(S, c * L + L))
            d = dt[:, sl].float()
            cum = torch.cumsum(d * A, 1)                     # (B,Lc,H)
            c_last = cum[:, -1]                              # (B,H)
            w = d * torch.exp(c_last[:, None] - cum)
            upd = torch.einsum("bjhp,bjhn->bhpn",
                               r16(w[..., None] * xf[:, sl]), Bh[:, sl])
            decay = torch.exp(c_last)[..., None, None]
            st_out = upd if st_in is None else st_in * decay + upd
            Lc = cum.shape[1]
            cb = torch.einsum("bihn,bjhn->bhij", Ch[:, sl], Bh[:, sl])
            ct = cum.permute(0, 2, 1)
            m = cb * torch.exp(ct[..., :, None] - ct[..., None, :]) \
                * d.permute(0, 2, 1)[..., None, :]
            m = torch.where(torch.tril(torch.ones(Lc, Lc, dtype=torch.bool)),
                            m, torch.zeros(()))
            yc = torch.einsum("bhij,bjhp->bihp", r16(m), xf[:, sl])
            if st_in is not None:
                yc = yc + torch.einsum("bihn,bhpn->bihp", Ch[:, sl],
                                       rtf(st_in)) \
                    * torch.exp(cum)[..., None]
            y[:, sl] = yc
            if c == n_chunks - 1:
                fin = st_out
            else:
                handed[c] = st_out
    assert not handed
    return y.to(x.dtype), fin


def _inputs(case, seed):
    B, S, H, P, G, N, _ = case
    rs = np.random.default_rng(seed)
    x = rs.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.logaddexp(rs.standard_normal((B, S, H)), 0).astype(np.float32)
    A = (-np.exp(rs.standard_normal(H) * 0.3)).astype(np.float32)
    Bm = (rs.standard_normal((B, S, G, N)) * 0.5).astype(np.float32)
    Cm = (rs.standard_normal((B, S, G, N)) * 0.5).astype(np.float32)
    return x, dt, A, Bm, Cm


EMU_CASES = [
    # B, S, H, P, G, N, chunk
    (1, 200, 2, 16, 1, 16, 64),     # ragged S: 4 chunks, the last 8 rows
    (1, 100, 2, 16, 1, 16, 256),    # S < L: one chunk of 128 walked
    (1, 650, 2, 16, 1, 16, 64),     # 11 chunks: two rounds of 8 blocks
    (2, 320, 2, 16, 1, 16, 64),     # 5 chunks on 8 blocks: 3 slots spare
    (1, 256, 4, 16, 2, 16, 64),     # G = 2
    (1, 192, 2, 64, 1, 64, 64),     # P = N = 64
    (1, 192, 2, 128, 1, 128, 64),   # P = N = 128
    (1, 130, 2, 16, 1, 128, 64),    # P 16, N 128
    (1, 600, 2, 64, 1, 64, 256),    # L = 256, 3 chunks, ragged
]


@pytest.mark.parametrize("case", EMU_CASES, ids=str)
def test_v3_emulated_matches_reference_in_f32(case):
    """The cluster's chunk order and state hand-off are the reference's
    scan: within its own tolerance (1e-3) of `ssd_pallas` in interpret
    mode and of `ssd_naive`."""
    arrs = _inputs(case, 25)
    ty, tfin = _v3_emulated(*(torch.from_numpy(a) for a in arrs),
                            chunk=case[-1])
    ja = [jnp.asarray(a) for a in arrs]
    for jy, js in (jax_ssd_naive(*ja),
                   ssd_pallas(*ja, chunk=case[-1], interpret=True)):
        assert np.abs(np.asarray(jy) - ty.numpy()).max() < 1e-3
        assert np.abs(np.asarray(js) - tfin.numpy()).max() < 1e-3


def _bf16_case(case, seed):
    """bf16 x, B, C (f32 dt, A): the emulated kernel and the reference's
    f32 quadratic form on the same rounded inputs."""
    x, dt, A, Bm, Cm = _inputs(case, seed)
    xb, Bb, Cb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, Bm, Cm))
    jy, js = jax_ssd_naive(*(jnp.asarray(a) for a in (
        xb.float().numpy(), dt, A, Bb.float().numpy(), Cb.float().numpy())))
    y, st = _v3_emulated(xb, torch.from_numpy(dt), torch.from_numpy(A), Bb,
                         Cb, chunk=case[-1])
    return (xb, Bb, Cb, dt, A), np.asarray(jy), np.asarray(js), y, st


@pytest.mark.parametrize("case", EMU_CASES + [(1, 1024, 4, 64, 1, 64, 256)],
                         ids=str)
def test_v3_rounding_points_stay_within_bound(case):
    """bf16 M and scaled x, a tf32 state operand: within the card tests'
    bound, 1e-2 of max|y| and of max|state|, of the reference's f32
    quadratic form on the same bf16 inputs."""
    _, jy, js, y, st = _bf16_case(case, 13)
    assert y.dtype == torch.bfloat16
    assert np.abs(y.float().numpy() - jy).max() <= 1e-2 * np.abs(jy).max()
    assert np.abs(st.numpy() - js).max() <= 1e-2 * np.abs(js).max()


def test_v3_rounding_is_there():
    """The rounding points move y and the state off the f32 chunked scan
    of the same bf16 inputs: the emulation does round where the kernel
    does."""
    case = (1, 1024, 4, 64, 1, 64, 256)
    (xb, Bb, Cb, dt, A), _, _, y, st = _bf16_case(case, 13)
    y32, st32 = ssd_scan(xb.float(), torch.from_numpy(dt),
                         torch.from_numpy(A), Bb.float(), Cb.float(),
                         chunk=case[-1])
    assert not torch.equal(y, y32.to(torch.bfloat16))
    assert not torch.equal(st, st32)
    # the state's error is the bf16 update's, far inside the bound
    assert 0 < float((st - st32).abs().max()) < \
        1e-2 * float(st32.abs().max())


# ------------------------------ the route ------------------------------- #
def _ssd_archs():
    return [a for a in list_archs() if get_config(a).ssm_state > 0]


@pytest.mark.parametrize("arch", _ssd_archs())
@pytest.mark.parametrize("S", [1, 300, 2048, 4096])
def test_every_registered_ssd_config_takes_wgmma_in_bf16(arch, S):
    """zamba2 (P = N = 64) and mamba2 (P = 64, N = 128) at chunk 256: v3
    in bf16 at a prompt of any length, v1 in f32 and f16."""
    cfg = get_config(arch)
    P, N, chunk = cfg.ssm_head_dim, cfg.ssm_state, cfg.ssd_chunk
    L = sk.wgmma_chunk(S, min(chunk, S))
    assert sk.ssd_route(torch.bfloat16, P, N, L, *ALIGNED) == "wgmma"
    for dtype in (torch.float32, torch.float16):
        assert sk.ssd_route(dtype, P, N, L, *ALIGNED) == "v1"


@pytest.mark.parametrize("P,N,L,ptrs,want", [
    (64, 64, 256, ALIGNED, "wgmma"), (8, 8, 64, ALIGNED, "wgmma"),
    (16, 128, 128, ALIGNED, "wgmma"), (128, 64, 256, ALIGNED, "wgmma"),
    (128, 128, 192, ALIGNED, "wgmma"), (24, 40, 192, ALIGNED, "wgmma"),
    (128, 128, 256, ALIGNED, "wgmma"), (72, 128, 128, ALIGNED, "wgmma"),
    (12, 64, 256, ALIGNED, "mma"), (64, 20, 256, ALIGNED, "mma"),
    (136, 64, 256, ALIGNED, "mma"), (64, 64, 320, ALIGNED, "mma"),
    (64, 64, 50, ALIGNED, "mma"), (64, 64, 32, ALIGNED, "mma"),
    (64, 64, 256, (2, 4096, 8192, 1 << 20), "mma"),   # x off 16 bytes
    (64, 64, 256, (0, 4096, 8192, (1 << 20) + 8), "mma"),
    (64, 64, 256, (0, 4096 + 16, 8192 + 32, 1 << 20), "wgmma")])
def test_route_rule_by_shape_chunk_and_alignment(P, N, L, ptrs, want):
    """A tensor map takes rows of whole 16-byte units (P, N multiples of
    8) at 16-byte base addresses; the kernel's tiles take chunks of 64 to
    256 rows; f32 and f16 always take the CUDA cores."""
    assert sk.ssd_route(torch.bfloat16, P, N, L, *ptrs) == want
    for dtype in (torch.float32, torch.float16):
        assert sk.ssd_route(dtype, P, N, L, *ptrs) == "v1"


@pytest.mark.parametrize("S,L,want", [
    (1, 1, 64), (64, 64, 64), (100, 100, 128), (256, 256, 256),
    (2048, 256, 256), (300, 256, 256), (257, 256, 256), (500, 500, 512),
    (300, 50, 50), (4096, 256, 256)])
def test_wgmma_chunk_walks_one_chunk_of_s_rounded_up(S, L, want):
    """L = min(chunk, S): several chunks keep L; a lone chunk is walked as
    S rounded up to a 64-row tile (past 256 it is not v3's)."""
    assert sk.wgmma_chunk(S, L) == want


# ------------------------------ the cluster ------------------------------ #
@pytest.mark.parametrize("n", range(1, 21))
def test_cluster_walk_runs_every_chunk_once(n):
    CL, walk = sk.cluster_walk(n)
    assert CL == (8 if n > 1 else 1)
    assert sorted(c for w in walk for c in w) == list(range(n))
    for r, chunks in enumerate(walk):
        assert chunks == list(range(r, n, CL))


def _st_off(p, n):
    """csrc/ssd_scan_wgmma.cu st_off: y_off's K-major tf32 layout of a
    64-row slice of the state, in floats."""
    return ((n >> 5) * (64 * 128) + p * 128
            + ((((n & 31) >> 2) ^ (p & 7)) << 4) + (n & 3) * 4) // 4


def _slice_off(NP, s, row, n):
    """csrc/ssd_scan_wgmma.cu slice_off (RS = 8 rows a slice): slot s of a
    scanning block's buffer, 8-column groups swizzled by row, in
    floats."""
    return (s * 8 + row) * NP + ((((n >> 3) ^ row) & (NP // 8 - 1)) << 3) \
        + (n & 7)


def _cluster_scan(U, D, NP, kscan):
    """The kernel's step (4), played with its index arithmetic over the
    blocks of one cluster: each live block sends its update's (p, n..n+1)
    pairs, as warpgroup 0's accumulators hold them, to block p // 8 at
    slot r; each block scans its rows (scanning thread tid's pairs 2 (tid
    + kscan j)) over the round's chunks; each chunk's entering rows go back
    to its block in st_off's layout.  Returns each chunk's entering state
    as its block reads it, and the final state as the scanning blocks
    write it."""
    n_chunks = len(U)
    CL, walk = sk.cluster_walk(n_chunks)
    if CL == 1:
        return [np.zeros((64, NP))], U[0]
    SJ = 8 * NP // 2 // kscan
    buf = [np.full(64 * NP, np.nan) for _ in range(CL)]
    carry = [np.zeros((kscan, SJ, 2)) for _ in range(CL)]   # a thread's
    fin = np.full((64, NP), np.nan)
    entering = {}
    for rnd in range(-(-n_chunks // CL)):
        n_live = min(CL, n_chunks - rnd * CL)
        slot = [np.full(64 * NP, np.nan) for _ in range(CL)]
        decay = np.full(CL, np.nan)
        for r in range(n_live):                   # a
            c = rnd * CL + r
            decay[r] = D[c]
            for p in range(64):
                for n in range(0, NP, 2):
                    o = _slice_off(NP, r, p % 8, n)
                    assert np.isnan(slot[p // 8][o:o + 2]).all()
                    slot[p // 8][o:o + 2] = U[c][p, n:n + 2]
        for k in range(CL):                       # b, c
            for tid in range(kscan):
                for j in range(SJ):
                    e = 2 * (tid + kscan * j)
                    row, n = e // NP, e % NP
                    for sl in range(n_live):
                        o = _slice_off(NP, sl, row, n)
                        u = slot[k][o:o + 2]
                        assert not np.isnan(u).any()
                        p = k * 8 + row
                        buf[sl][[_st_off(p, n), _st_off(p, n + 1)]] \
                            = carry[k][tid, j]
                        carry[k][tid, j] = carry[k][tid, j] * decay[sl] + u
                    if rnd == -(-n_chunks // CL) - 1:
                        fin[k * 8 + row, n:n + 2] = carry[k][tid, j]
        for r in range(n_live):
            entering[rnd * CL + r] = np.array(
                [[buf[r][_st_off(p, n)] for n in range(NP)]
                 for p in range(64)])
    return [entering[c] for c in range(n_chunks)], fin


@pytest.mark.parametrize("NP", [64, 128])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 9, 12, 16, 17, 20])
def test_cluster_scan_hands_each_chunk_its_state(NP, n):
    """Every element of every update reaches its row's scanning block
    once, and every chunk's block finds the state entering it (the carry
    over the chunks before it, in order) in y_off's layout; the last
    round writes the final state.  1 to 20 chunks: one block, one round
    with spare slots, and rounds; scanned by warpgroup 0 (N <= 64) or by
    both (N = 128)."""
    rng = np.random.default_rng(n)
    U = rng.integers(-4, 5, (n, 64, NP)).astype(np.float64)
    D = rng.choice([0.5, 0.25, 1.0], n)
    entering, fin = _cluster_scan(U, D, NP, 128 if NP == 64 else 256)
    state = np.zeros((64, NP))
    for c in range(n):
        assert np.array_equal(entering[c], state), c
        state = state * D[c] + U[c]
    assert np.array_equal(fin, state)


# ------------------------- counters and the build ------------------------ #
def test_route_counters_and_v2_entry_refuse_the_cpu():
    """One counter a tensor-core route; the v2 entry, like the launch,
    takes CUDA tensors only, and a CPU call counts nothing."""
    assert set(sk.LAUNCHES) == {"ssd_scan", "ssd_scan.wgmma",
                                "ssd_scan.mma"}
    x = torch.zeros((1, 4, 2, 8), dtype=torch.bfloat16)
    dt = torch.zeros((1, 4, 2))
    bc = torch.zeros((1, 4, 1, 8), dtype=torch.bfloat16)
    before = dict(sk.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        sk.ssd_scan_v2(x, dt, torch.zeros(2), bc, bc, 4)
    with pytest.raises(ValueError, match="CUDA"):
        sk._launch_ssd_scan(x, dt, torch.zeros(2), bc, bc, 4)
    sk.ssd_scan(x, dt, torch.zeros(2), bc, bc, chunk=4)
    assert sk.LAUNCHES == before
    sk.reset_launches()
    assert set(sk.LAUNCHES.values()) == {0}
    sk.LAUNCHES.update(before)


def test_build_names_the_wgmma_ssd_source():
    names = [p.name for p in kernels_build.SOURCES]
    assert "ssd_scan_wgmma.cu" in names and "ssd_scan_mma.cu" in names
    csrc = kernels_build.SOURCES[0].parent
    kernel = (csrc / "ssd_scan_wgmma.cu").read_text()
    assert not re.search(r"#include\s*[<\"](torch|ATen|c10|cute|cutlass)",
                         kernel)
    for what in ("cudaLaunchAttributeClusterDimension", "tensor_map(",
                 "WgmmaTf32::", "ss_n64", "cluster_sync_all", "st_peer_v2",
                 "src/repro/kernels/ssd/kernel.py"):
        assert what in kernel, what
    ptx = (csrc / "wgmma_sm90.cuh").read_text()
    for op in ("st.shared::cluster", "mapa.shared::cluster",
               "barrier.cluster.arrive.release", ".tf32.tf32"):
        assert op in ptx, op
    entry = (csrc / "ssd_scan.cu").read_text()
    assert "ssd_scan_wgmma(" in entry and "ssd_scan_v2_launch" in entry
    assert kernels_build._SIGNATURES["ssd_scan_v2_launch"] == \
        kernels_build._SIGNATURES["ssd_scan_launch"]


def test_meta_trace_of_a_prefill_counts_the_same_flops():
    """The reduced zamba2 bf16 prefill on meta tensors: the op's fake
    shapes the trace and its FLOP formula counts what it counted before
    the wgmma route (`ssd_ops` a layer; the step's dot FLOPs as
    before)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs.base import ShapeConfig, reduced_config
    from repro_torch.launch import dryrun
    cfg = reduced_config(get_config("zamba2-7b")).replace(
        dtype="bfloat16", use_pallas=True, attn_impl="flash")
    n_ssd = sum(g.repeat * sum(ls.mixer == "ssd" for ls in g.layers)
                for g in cfg.groups)
    before = dict(sk.LAUNCHES)
    with FlopCounterMode(display=False) as fc:
        tr = dryrun.trace_cell(cfg, ShapeConfig("p", 256, 2, "prefill"),
                               None)
    counts = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    one = sk.ssd_ops(2, 256, cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state,
                     cfg.ssd_chunk)
    assert counts["repro_torch.ssd_scan"] == n_ssd * one == 89915392
    assert tr["analysis"]["dot_flops"] == 537853952
    assert sk.LAUNCHES == before
