"""The wgmma flash kernel's host half on the CPU (no card, no nvcc): the
route rule of `flash_fwd` (`flash_route`), the build's sources, the custom
op's fake and FLOP formula on a meta trace, and the kernel's walk over the
tiles (`tile_walk`) and the blocks (`block_order`).  The kernel's
arithmetic, emulated in torch ops block by block as the card runs it (128-
row q tiles in two 64-row halves, 128-row kv tiles, the mask only on tiles
that cross its edge, exp2 of log2-domain scores flushed below 2^-126, p
rounded to the input dtype), is held against the reference's Pallas
kernel in interpret mode."""
import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import flash_fwd_pallas  # noqa: E402

from repro_torch import kernels_build  # noqa: E402
from repro_torch.configs.base import get_config, list_archs  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402

NEG2 = -1e30 * math.log2(math.e)   # a masked score in the log2 domain
ALIGNED = (0, 4096, 8192, 1 << 20)  # q, k, v, out base addresses


# ------------------------------ the route ------------------------------- #
def _attention_archs():
    return [a for a in list_archs() if get_config(a).head_dim > 0]


@pytest.mark.parametrize("arch", _attention_archs())
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_every_registered_head_dim_takes_its_route(arch, dtype):
    """The card's configs: 64, 112 and 128 on wgmma, zamba2-7b-instruct's
    224 and gemma3's 240 on mma.sync (a head dim past two 64-column
    boxes)."""
    D = get_config(arch).head_dim
    want = "wgmma" if D in (64, 112, 128) else "mma"
    assert D in (64, 112, 128, 224, 240), (arch, D)
    assert fk.flash_route(dtype, D, *ALIGNED) == want


@pytest.mark.parametrize("D,ptrs,want", [
    (8, ALIGNED, "wgmma"), (24, ALIGNED, "wgmma"), (120, ALIGNED, "wgmma"),
    (20, ALIGNED, "mma"), (36, ALIGNED, "mma"), (113, ALIGNED, "mma"),
    (136, ALIGNED, "mma"), (240, ALIGNED, "mma"),
    (64, (0, 4096, 8192, (1 << 20) + 8), "mma"),   # out 8-byte aligned
    (128, (2, 4096, 8192, 1 << 20), "mma"),        # q off by one element
    (112, (0, 4096 + 16, 8192 + 32, 1 << 20), "wgmma")])
def test_route_rule_by_head_dim_and_alignment(D, ptrs, want):
    """A tensor map takes strides of 16 bytes (D a multiple of 8) and
    16-byte base addresses; wgmma's two boxes hold D <= 128.  Anything
    else in 16 bits goes to mma.sync; f32 always to the CUDA cores."""
    for dtype in (torch.bfloat16, torch.float16):
        assert fk.flash_route(dtype, D, *ptrs) == want
    assert fk.flash_route(torch.float32, D, *ptrs) == "v1"


def test_route_counters_and_v2_entry_refuse_the_cpu():
    """The launches keep one counter a route; the v2 entry, like the
    launch, takes CUDA tensors only, and a CPU call counts nothing."""
    assert set(fk.LAUNCHES) == {"flash_fwd", "flash_fwd.wgmma",
                                "flash_fwd.mma"}
    q = torch.zeros((1, 4, 2, 8), dtype=torch.bfloat16)
    before = dict(fk.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        fk.flash_fwd_v2(q, q, q)
    fk.flash_fwd(q, q, q)
    assert fk.LAUNCHES == before


# ------------------------------ the build ------------------------------- #
def test_build_names_the_wgmma_sources():
    names = {p.name for p in kernels_build.SOURCES}
    assert {"flash_fwd_wgmma.cu", "flash_fwd_mma.cu",
            "flash_fwd.cu"} <= names
    assert {p.name for p in kernels_build.HEADERS} == {"mma_sm90.cuh",
                                                       "wgmma_sm90.cuh"}
    for path in kernels_build.SOURCES + kernels_build.HEADERS:
        text = path.read_text()
        assert not re.search(r"#include\s*[<\"](torch|ATen|c10|cute|cutlass)",
                             text), path.name
    ptx = (kernels_build.SOURCES[0].parent / "wgmma_sm90.cuh").read_text()
    for op in ("wgmma.mma_async", "cp.async.bulk.tensor", "mbarrier",
               "setmaxnreg", "fence.proxy.async"):
        assert op in ptx, op
    kernel = (kernels_build.SOURCES[0].parent
              / "flash_fwd_wgmma.cu").read_text()
    assert "cuTensorMapEncodeTiled" in kernel
    assert "-lcuda" not in " ".join(kernels_build.NVCC_FLAGS)
    assert kernels_build._SIGNATURES["flash_fwd_v2_launch"] == \
        kernels_build._SIGNATURES["flash_fwd_launch"]


# ------------------- the custom op on a meta trace ---------------------- #
def test_meta_trace_of_a_prefill_counts_the_same_flops():
    """The reduced zamba2 bf16 prefill (two shared-attention hits) on meta
    tensors: the op's fake shapes the trace and its FLOP formula counts
    what it counted before the wgmma route (the step's dot FLOPs as the
    tree before it counted them)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs.base import ShapeConfig, reduced_config
    from repro_torch.launch import dryrun
    cfg = reduced_config(get_config("zamba2-7b")).replace(
        dtype="bfloat16", use_pallas=True, attn_impl="flash")
    before = dict(fk.LAUNCHES)
    with FlopCounterMode(display=False) as fc:
        tr = dryrun.trace_cell(cfg, ShapeConfig("p", 256, 2, "prefill"),
                               None)
    counts = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    one = fk.flash_fwd_flops(2, 256, 256, cfg.num_heads, cfg.head_dim,
                             True, 0)
    assert counts["repro_torch.flash_fwd"] == 2 * one == 33685504
    assert tr["analysis"]["dot_flops"] == 537853952
    assert fk.LAUNCHES == before


# ---------------------------- the tile walk ------------------------------ #
def _live(Sq, Skv, causal, window):
    i = np.arange(Sq)[:, None]
    j = np.arange(Skv)[None, :]
    m = np.ones((Sq, Skv), bool)
    if causal:
        m &= j <= i
    if window:
        m &= j > i - window
    return m


def _walk_cases():
    rng = np.random.default_rng(24)
    cases = [(2048, 2048, True, 0), (2048, 2048, False, 0),
             (300, 300, True, 100), (100, 37, True, 0), (37, 300, False, 9),
             (300, 50, True, 20), (129, 129, True, 1), (1, 1, True, 0),
             (256, 128, False, 64), (500, 500, True, 128)]
    for _ in range(40):
        cases.append((int(rng.integers(1, 600)), int(rng.integers(1, 600)),
                      bool(rng.integers(2)),
                      int(rng.choice([0, 1, 17, 128, 300]))))
    return cases


@pytest.mark.parametrize("Sq,Skv,causal,window", _walk_cases())
def test_tile_walk_covers_every_live_pair_once(Sq, Skv, causal, window):
    """Each (q tile, kv tile) the walk visits holds a live pair, every
    live pair lies in exactly one visited tile, and the walk's live pairs
    add up to `live_pairs` (the FLOP formula's count)."""
    T = fk.WGMMA_TILE
    live = _live(Sq, Skv, causal, window)
    seen = np.zeros_like(live, dtype=np.int64)
    walk = fk.tile_walk(Sq, Skv, causal, window)
    starts = [q0 for q0, _ in walk]
    assert starts == sorted(starts, reverse=True) == \
        list(range(0, Sq, T))[::-1]
    total = 0
    for q0, kts in walk:
        assert kts == sorted(set(kts))
        for kt in kts:
            block = live[q0:q0 + T, kt * T:(kt + 1) * T]
            assert block.size and block.any(), (q0, kt)
            seen[q0:q0 + T, kt * T:(kt + 1) * T] += 1
            total += int(block.sum())
    assert seen.max() <= 1
    assert bool((seen[live] == 1).all())
    assert total == int(live.sum()) == fk.live_pairs(Sq, Skv, causal,
                                                     window)


@pytest.mark.parametrize("B,S,Hq,Hkv,D", [
    (4, 2048, 32, 32, 112), (4, 2048, 32, 4, 128), (4, 2048, 16, 16, 64),
    (2, 2048, 16, 16, 112), (2, 2048, 16, 2, 128), (1, 2048, 16, 16, 112),
    (3, 300, 6, 2, 64), (2, 65536, 4, 1, 128)])
def test_block_order_groups_heads_by_their_kv_bytes(B, S, Hq, Hkv, D):
    """Every (q tile, head, batch) once; the heads in groups of one size
    whose K and V fit the L2 budget (or one kv head, when one alone does
    not), q heads that read one kv head in one group, and each group's
    blocks from the heaviest q tile down."""
    order = fk.block_order(B, S, S, Hq, Hkv, D)
    T, G = fk.WGMMA_TILE, Hq // Hkv
    tiles = list(range(0, S, T))
    assert len(tiles) > 1
    assert sorted(order) == sorted((q0, h, b) for q0 in tiles
                                   for h in range(Hq) for b in range(B))
    # a group ends where the q tile climbs back to the top
    groups, cur = [], []
    for blk in order:
        if cur and blk[0] > cur[-1][0]:
            groups.append(cur)
            cur = []
        cur.append(blk)
    groups.append(cur)
    kv_bytes = 2 * S * D * 2               # K and V of one kv head
    seen = set()
    for g in groups:
        pairs = {(b, h) for _, h, b in g}
        assert [q0 for q0, _, _ in g] == sorted(
            [q0 for q0 in tiles for _ in pairs], reverse=True)
        assert not pairs & seen
        seen |= pairs
        kv_heads = {(b, h // G) for b, h in pairs}
        assert len(kv_heads) * G == len(pairs)
        assert len(kv_heads) * kv_bytes <= fk.WGMMA_L2_BUDGET or \
            len(kv_heads) == 1
    assert len(seen) == B * Hq
    assert len({len(g) for g in groups[:-1]}) <= 1
    assert len(groups[-1]) <= len(groups[0])


# ------------------- the kernel's arithmetic, emulated ------------------- #
def _v3_emulated(q, k, v, causal, window):
    """The wgmma kernel block by block in torch ops on the CPU: scores in
    f32 from the 16-bit inputs, log2 domain, the raw scores' max on tiles
    that no mask edge crosses, exp2 flushed below 2^-126, p rounded to
    q's dtype before P V, l clamped at 1e-37."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G, T, R = Hq // Hkv, fk.WGMMA_TILE, fk.WGMMA_TILE // 2
    sl = 1.0 / math.sqrt(D) * math.log2(math.e)
    out = torch.zeros((B, Sq, Hq, D), dtype=torch.float32)
    lse = torch.zeros((B, Sq, Hq), dtype=torch.float32)
    walk = dict(fk.tile_walk(Sq, Skv, causal, window))
    qf, kf, vf = q.float(), k.float(), v.float()
    for q0, h, b in fk.block_order(B, Sq, Skv, Hq, Hkv, D):
        for r0 in (q0, q0 + R):
            rows = torch.arange(r0, r0 + R)
            qs = torch.zeros((R, D))
            n = max(0, min(Sq, r0 + R) - r0)
            qs[:n] = qf[b, r0:r0 + n, h]
            m = torch.full((R,), NEG2)
            l = torch.zeros(R)
            o = torch.zeros((R, D))
            for kt in walk[q0]:
                k0 = kt * T
                ks, vs = torch.zeros((T, D)), torch.zeros((T, D))
                nk = min(Skv, k0 + T) - k0
                ks[:nk], vs[:nk] = kf[b, k0:k0 + nk, h // G], \
                    vf[b, k0:k0 + nk, h // G]
                s = qs @ ks.T
                edge = (k0 + T > Skv or (causal and k0 + T - 1 > r0)
                        or (window and k0 <= r0 + R - 1 - window))
                if edge:
                    kpos = torch.arange(k0, k0 + T)[None, :]
                    alive = kpos < Skv
                    if causal:
                        alive = alive & (kpos <= rows[:, None])
                    if window:
                        alive = alive & (kpos > rows[:, None] - window)
                    s = torch.where(alive, s * sl, torch.tensor(NEG2))
                    mx = torch.maximum(m, s.amax(1))
                    x = s - mx[:, None]
                else:
                    mx = torch.maximum(m, s.amax(1) * sl)
                    x = s * sl - mx[:, None]
                p = torch.exp2(x)
                p = torch.where(p < 2.0 ** -126, torch.zeros(()), p)
                corr = torch.exp2(m - mx)
                corr = torch.where(corr < 2.0 ** -126, torch.zeros(()), corr)
                l = l * corr + p.sum(1)
                o = o * corr[:, None] + p.to(q.dtype).float() @ \
                    vs.to(q.dtype).float()
                m = mx
            lc = l.clamp_min(1e-37)
            out[b, r0:r0 + n, h] = (o / lc[:, None])[:n]
            lse[b, r0:r0 + n, h] = (m / math.log2(math.e)
                                    + torch.log(lc))[:n]
    return out.to(q.dtype), lse


FLASH_CASES = [
    # B, Sq, Skv, Hq, Hkv, D, causal, window: the reference's kernel
    # tests, then the wgmma tiles' edges (two halves, a padded box, ragged
    # kv past a tile, a window inside a tile, a wholly masked tail)
    (2, 128, 128, 4, 2, 32, True, 0),
    (1, 100, 100, 4, 4, 16, True, 0),
    (2, 128, 128, 8, 2, 32, True, 24),
    (2, 64, 128, 4, 2, 16, False, 0),
    (1, 256, 256, 2, 1, 64, True, 0),
    (1, 200, 200, 2, 2, 112, True, 0),
    (1, 130, 260, 2, 1, 8, False, 0),
    (1, 300, 150, 2, 1, 24, True, 40),
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wgmma_arithmetic_matches_the_reference_kernel(case, dtype):
    """The emulated kernel (f32 inputs stand for the f32-exact products
    of 16-bit ones) against `flash_fwd_pallas` in interpret mode, on the
    rows that have a live key, at the reference's tolerances."""
    B, Sq, Skv, Hq, Hkv, D, causal, window = case
    rs = np.random.default_rng(24)
    arrays = [rs.standard_normal(s).astype(np.float32)
              for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D))]
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jq, jk, jv = (jnp.asarray(a, jd) for a in arrays)
    tq, tk, tv = (torch.from_numpy(a).to(td) for a in arrays)
    want, wlse = flash_fwd_pallas(jq, jk, jv, causal=causal, window=window,
                                  interpret=True)
    out, lse = _v3_emulated(tq, tk, tv, causal, window)
    want = np.asarray(want, np.float32)
    wlse = np.asarray(wlse, np.float32)
    live = wlse > -1e29
    assert np.array_equal(live, lse.numpy() > -1e29)
    assert bool(torch.isfinite(out.float()).all())
    tol, ltol = (2e-5, 1e-4) if dtype == "float32" else (2e-2, 2e-2)
    assert float(np.abs(out.float().numpy() - want)[live].max()) < tol
    assert float(np.abs(lse.numpy() - wlse)[live].max()) < ltol
