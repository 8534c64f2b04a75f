"""The compiled CUDA kernels of `repro_torch` against their plain PyTorch
versions on the same CUDA tensors, over randomized shapes beyond the main
path's (odd piece counts, empty rows, every route of the fused orders and
of the dense and ragged matcher, with the route read from `LAUNCHES`),
plus the torch-op functions on CUDA against the same ops on the
CPU, and a small batched flash crowd, chaos runs and an image upgrade
on the card against the CPU path.

These tests need an NVIDIA card and nvcc; they skip elsewhere.  Run them
on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture
def sk():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch import kernels_build
    if kernels_build.find_nvcc() is None:
        pytest.skip("needs nvcc to build the kernels")
    from repro_torch.core import swarm_kernels
    return swarm_kernels


def G(a):
    return torch.from_numpy(np.ascontiguousarray(a)).cuda()


@pytest.mark.parametrize("seed", range(4))
def test_rarest_keys_kernel_matches_plain(sk, seed):
    rs = np.random.default_rng(seed)
    for _ in range(10):
        R, P = int(rs.integers(1, 60)), int(rs.integers(1, 300))
        counts = G(rs.integers(0, 10_001, P))
        offsets = G(rs.integers(0, 100_000, R))
        missing = G(rs.random((R, P)) < 0.5)
        cost = G(rs.choice([0, 1, 15, 64], (R, P)))
        span = (int(counts.max()) + 1) * P * P
        n0 = sk.LAUNCHES["rarest_keys"]
        for kw in ({}, {"missing": missing},
                   {"missing": missing, "piece_cost": cost, "span": span}):
            got = sk.rarest_keys(counts, offsets, P, **kw)
            want = sk.rarest_keys_plain(counts, offsets, P, **kw)
            assert torch.equal(got, want)
        assert sk.LAUNCHES["rarest_keys"] == n0 + 3
        got = sk.cost_orders(missing, counts, offsets, cost, P)
        want = torch.sort(sk.rarest_keys_plain(
            counts, offsets, P, missing=missing, piece_cost=cost,
            span=span), dim=1, stable=True).indices.int()
        assert torch.equal(got, want)


@pytest.mark.parametrize("P", [1, 64, 65, 1024, 4096, 4097])
def test_fused_orders_match_keys_and_stable_sort(sk, P):
    """Both routes of the piece orders (the fused kernel, a warp a row, to
    64 pieces; keys then torch.sort above) against the plain keys and a
    stable argsort, with ties of KEY_INF."""
    rs = np.random.default_rng(P)
    route = sk._orders_route(P)
    for R in (1, 7, 300):
        counts = G(rs.integers(0, 3_000, P))
        offsets = G(rs.integers(0, 100_000, R))
        missing = G(rs.random((R, P)) < rs.choice([0.05, 0.5, 1.0]))
        cost = G(rs.choice([0, 1, 15, 64], (R, P)))
        n0 = dict(sk.LAUNCHES)
        got_r = sk.rarest_orders(missing, counts, offsets, P)
        got_c = sk.cost_orders(missing, counts, offsets, cost, P)
        torch.cuda.synchronize()
        assert sk.LAUNCHES["rarest_keys"] == n0["rarest_keys"] + 2
        assert sk.LAUNCHES[f"rarest_keys.{route}"] == \
            n0[f"rarest_keys.{route}"] + 2
        span = (int(counts.max()) + 1) * P * P
        for got, pc, sp in ((got_r, None, 0), (got_c, cost, span)):
            keys = sk.rarest_keys_plain(counts, offsets, P, missing=missing,
                                        piece_cost=pc, span=sp)
            want = torch.sort(keys, dim=1, stable=True).indices.int()
            assert got.dtype == torch.int32
            assert torch.equal(got, want), (P, R)


@pytest.mark.parametrize("seed", range(4))
def test_island_has_kernel_matches_plain(sk, seed):
    rs = np.random.default_rng(10 + seed)
    for _ in range(10):
        N, K, P = (int(rs.integers(1, 3000)), int(rs.integers(1, 12)),
                   int(rs.integers(1, 200)))
        have = G(rs.random((N, P)) < rs.choice([0.001, 0.05, 0.5]))
        member = np.zeros((K, N), dtype=np.uint8)
        member[rs.integers(0, K, N), np.arange(N)] = 1
        member = G(member)
        assert torch.equal(sk.island_has(have, member),
                           sk.island_has_plain(have, member))


def _cost_rows_inputs(rs, cap, n, P, K, R, max_cost=16):
    have = G((rs.random((cap, P)) < rs.choice([0.002, 0.05, 0.5]))
             .astype(np.uint8))
    full = G((rs.random(cap) < rs.choice([0.0, 0.05, 0.5])).astype(np.uint8))
    alive = G((rs.random(cap) < rs.choice([0.5, 0.9, 1.0])).astype(np.uint8))
    island = G(rs.integers(0, max(K - int(rs.integers(0, 2)), 1), cap))
    rows = G(rs.integers(0, max(n, 1), R))
    cost = G(rs.integers(0, max_cost, (K, K)))
    return have, full, alive, island, n, rows, cost


@pytest.mark.parametrize("seed", range(4))
def test_island_cost_rows_kernel_matches_plain(sk, seed):
    """The fused P4P cost rows over random shapes: N not a multiple of a
    warp's 32 rows or of the cluster's 64 warps, P not a multiple of 32
    (to the kernel's 4096), K to 64, empty islands, costs above
    COST_NONE, R = 0."""
    rs = np.random.default_rng(30 + seed)
    shapes = [(int(rs.integers(1, 3000)), int(rs.integers(1, 200)),
               int(rs.integers(1, 13)), None) for _ in range(8)]
    shapes += [(2049, 4096, 8, None), (700, 4095, 64, None),
               (33, 1000, 64, None), (500, 64, 8, 0), (1, 1, 1, None)]
    for n, P, K, R in shapes:
        cap = n + int(rs.integers(0, 40))
        R = int(rs.integers(1, 2 * n + 2)) if R is None else R
        args = _cost_rows_inputs(rs, cap, n, P, K, R,
                                 max_cost=int(rs.choice([16, 200])))
        n0 = sk.LAUNCHES["island_cost_rows"]
        got = sk.island_cost_rows(*args)
        torch.cuda.synchronize()
        assert sk.LAUNCHES["island_cost_rows"] == n0 + int(R > 0)
        want = sk.island_cost_rows_plain(*args)
        assert got.dtype == torch.int64
        assert torch.equal(got, want), (n, P, K, R)


def test_island_cost_rows_kernel_refuses_what_it_does_not_take(sk):
    rs = np.random.default_rng(5)
    have, full, alive, island, n, rows, cost = _cost_rows_inputs(
        rs, 40, 30, 64, 8, 10)
    n0 = dict(sk.LAUNCHES)
    bad = [
        (have.bool(), full, alive, island, n, rows, cost),
        (have, full.long(), alive, island, n, rows, cost),
        (have, full, alive, island.int(), n, rows, cost),
        (have, full[:-1], alive, island, n, rows, cost),
        (have, full, alive, island, n, rows, cost[:, :-1]),
        (have, full, alive, island, 41, rows, cost),
        (have.t(), full, alive, island, n, rows, cost),
    ]
    for args in bad:
        with pytest.raises((TypeError, ValueError)):
            sk._launch_island_cost_rows(*args)
    wide = G(np.zeros((40, 4097), dtype=np.uint8))
    with pytest.raises(ValueError, match="P <= 4096"):
        sk.island_cost_rows(wide, full, alive, island, n, rows, cost)
    many = G(np.zeros((65, 65), dtype=np.int64))
    with pytest.raises(ValueError, match="K <= 64"):
        sk.island_cost_rows(have, full, alive, island, n, rows, many)
    with pytest.raises(ValueError, match="mixed devices"):
        sk.island_cost_rows(have, full, alive, island, n, rows.cpu(), cost)
    assert sk.LAUNCHES == n0


def _match_case(rs, R, P, N, C):
    cand = np.stack([rs.choice(N, C, replace=C > N) for _ in range(R)])
    pad = rs.random((R, C)) < 0.1
    cand = np.where(pad, -1, cand).astype(np.int32)
    ok = (rs.random((R, C)) < 0.8) & ~pad
    key = rs.integers(0, 1 << int(rs.choice([2, 26])), (R, C)) \
        .astype(np.int32)
    return (G(np.stack([rs.permutation(P) for _ in range(R)])
              .astype(np.int32)),
            G(rs.integers(0, P + 2, R).astype(np.int32)),
            G(rs.integers(-1, 8, R).astype(np.int32)), G(cand), G(ok),
            G(key), G((rs.random((N, P)) < 0.3).astype(np.uint8)),
            G((rs.random(N) < 0.02).astype(np.uint8)))


def _ragged_from(rs, args, C):
    """A CSR case from a dense one: row r keeps its first deg[r] usable
    candidates (degrees 0..C), and walks a permuted order row."""
    orders, n_walk, budgets, cand, ok, key, have, full = args
    R = cand.shape[0]
    deg = torch.from_numpy(rs.integers(0, C + 1, R)).cuda()
    deg[0] = C
    keep = torch.arange(C, device="cuda")[None, :] < deg[:, None]
    keep &= cand >= 0
    ptr = torch.zeros(R + 1, dtype=torch.int32, device="cuda")
    ptr[1:] = torch.cumsum(keep.sum(dim=1), 0).to(torch.int32)
    row_of = torch.from_numpy(rs.permutation(R).astype(np.int32)).cuda()
    return (orders, row_of, ptr, cand[keep], ok[keep], key[keep], n_walk,
            budgets, have, full)


@pytest.mark.parametrize("P", [None, 1, 7, 33, 48, 64, 65, 100, 128])
@pytest.mark.parametrize("C", [1, 7, 8, 9, 31, 33, 200, 512, 2048, 13_000])
def test_match_requests_kernel_matches_plain(sk, C, P):
    """Dense and ragged launches over every route: 1..16 slots a lane on
    the register route (P <= 64, degrees to 512; P = 7, 33, 48 take the
    have rows' byte loop and partial 16-byte loads) and the wide route (P >
    64 or a degree above 512; P = 128 is Scenario X's width), read from
    LAUNCHES.  P None draws three piece counts in 1..100."""
    rs = np.random.default_rng(C * 1000 + (P or 0))
    for _ in range(3):
        R = int(rs.integers(1, 300))
        Pd = P or int(rs.integers(1, 100))
        route = sk._match_route(Pd, C)
        args = _match_case(rs, R, Pd, max(C, 50), C)
        n0 = dict(sk.LAUNCHES)
        got = sk.match_requests(*args)
        torch.cuda.synchronize()
        assert sk.LAUNCHES["match_requests"] == n0["match_requests"] + 1
        assert sk.LAUNCHES[f"match_requests.{route}"] == \
            n0[f"match_requests.{route}"] + 1
        assert torch.equal(got, sk.match_requests_plain(*args)), (C, Pd, R)
        rag = _ragged_from(rs, args, C)
        ptr_host = rag[2].cpu().numpy()
        for host in (None, ptr_host):
            n0 = dict(sk.LAUNCHES)
            got = sk.match_requests_ragged(*rag, cand_ptr_host=host)
            torch.cuda.synchronize()
            rroute = sk._match_route(Pd, int(np.diff(ptr_host).max()))
            assert sk.LAUNCHES[f"match_requests.{rroute}"] == \
                n0[f"match_requests.{rroute}"] + 1
            assert torch.equal(got, sk.match_requests_ragged_plain(*rag)), \
                (C, Pd, R)


def test_match_requests_scratch_path_matches_plain(sk):
    """C far above the register route's 512 takes the wide route, each
    candidate slot's word and mask words in a scratch beside the rows."""
    rs = np.random.default_rng(99)
    C = 48 * 1024 + 1000
    args = _match_case(rs, 6, 16, C + 10, C)
    n0 = sk.LAUNCHES["match_requests.wide"]
    got = sk.match_requests(*args)
    assert torch.equal(got, sk.match_requests_plain(*args))
    assert sk.LAUNCHES["match_requests.wide"] == n0 + 1
    assert int((got >= 0).sum()) > 0


@pytest.mark.parametrize("seed", range(3))
def test_torch_ops_on_cuda_match_cpu(sk, seed):
    rs = np.random.default_rng(50 + seed)
    H, C = int(rs.integers(1, 40)), int(rs.integers(1, 300))
    rates = np.array([0.0, 0.0, 1.5, 7.25, 100.0], dtype=np.float32)
    recv = rates[rs.integers(0, 5, (H, C))]
    sent = rates[rs.integers(0, 5, (H, C))]
    cand = rs.random((H, C)) < 0.6
    ranks = rs.integers(0, 4, (H, C)) * 2 ** 20 + rs.permutation(C)
    got = sk.choke_order(G(recv), G(sent), G(cand), G(ranks)).cpu()
    want = sk.choke_order(*(torch.from_numpy(a) for a in
                            (recv, sent, cand, ranks)))
    assert torch.equal(got, want)
    n, p = int(rs.integers(1, 500)), int(rs.integers(1, 80))
    keys = np.where(rs.random((n, p)) < 0.5,
                    rs.permutation(n * p).reshape(n, p),
                    int(sk.KEY_INF32)).astype(np.int32)
    for k in (1, 7, n + 3):
        assert torch.equal(sk.holder_topk(G(keys), k).cpu(),
                           sk.holder_topk(torch.from_numpy(keys), k))


def test_small_flash_crowd_on_cuda_matches_cpu(sk):
    from repro_torch.scenarios import scenario_ix, scenario_vii
    keys = ("events", "makespan_s", "full_replication_s", "origin_up_mb")
    a = scenario_vii(verbose=False, n_volunteers=24, batched=True,
                     device="cuda")
    b = scenario_vii(verbose=False, n_volunteers=24, batched=True,
                     device="cpu")
    assert a["device"].startswith("cuda")
    assert {k: a[k] for k in keys} == {k: b[k] for k in keys}
    n0 = dict(sk.LAUNCHES)
    a = scenario_ix(verbose=False, n_volunteers=24, n_islands=3,
                    device="cuda")
    n = {k: sk.LAUNCHES[k] - n0[k] for k in n0}
    b = scenario_ix(verbose=False, n_volunteers=24, n_islands=3,
                    device="cpu")
    # the P4P arm's pumps: one cost-rows launch each, never island_has
    assert n["island_cost_rows"] > 0 and n["island_has"] == 0
    assert n["island_cost_rows"] <= n["rarest_keys"]
    for arm in ("naive", "p4p"):
        assert {k: a[arm][k] for k in keys + ("cross_isp_bytes",)} == \
            {k: b[arm][k] for k in keys + ("cross_isp_bytes",)}


def test_small_chaos_and_upgrade_on_cuda_match_cpu(sk):
    """Churn, loss and a partition (Scenario VIII batched, and a chaos run
    on islands with an island cut off) and an upgrade at 80 pieces
    (Scenario X: the orders' sort route, the matcher's wide route) give
    the CPU path's results on the card, with the invariants (device
    planes included) checked on the card."""
    from repro_torch.core.chaos import ChaosScenario
    from repro_torch.scenarios import (scenario_viii, scenario_x,
                                       virtual_time_fields)
    runs = [("scenario_viii", scenario_viii,
             dict(n_volunteers=24, batched=True)),
            ("scenario_x", scenario_x,
             dict(n_volunteers=24, image_mb=8.0, n_pieces=80,
                  include_chaos=False))]
    for name, fn, params in runs:
        n0 = dict(sk.LAUNCHES)
        a = fn(verbose=False, device="cuda", **params)
        b = fn(verbose=False, device="cpu", **params)
        assert a["device"].startswith("cuda")
        assert virtual_time_fields(name, a) == virtual_time_fields(name, b)
        n = {k: sk.LAUNCHES[k] - n0[k] for k in n0}
        if name == "scenario_x":
            assert n["rarest_keys.sort"] == n["rarest_keys"] > 0
            assert n["match_requests.wide"] == n["match_requests"] > 0
        else:
            assert n["rarest_keys.warp"] == n["rarest_keys"] > 0
    params = dict(seed=3, n_volunteers=8, n_pieces=12, n_parts=16,
                  image_bytes=96_000, real_image=False, batched=True,
                  n_islands=3, island_partitions=True)
    n0 = dict(sk.LAUNCHES)
    a = ChaosScenario(device="cuda", **params).run()
    a.check_invariants()
    n = {k: sk.LAUNCHES[k] - n0[k] for k in n0}
    b = ChaosScenario(device="cpu", **params).run()
    # every pump is a P4P pump here: one cost-rows launch each
    assert n["island_cost_rows"] == n["rarest_keys"] > 0
    assert n["island_has"] == 0
    assert virtual_time_fields("chaos", a.report()) == \
        virtual_time_fields("chaos", b.report())


# ================= the model stack's kernels: flash and SSD ============== #
_F16 = (torch.float32, torch.bfloat16, torch.float16)


@pytest.fixture
def mk():
    """The flash and SSD kernel modules, with TF32 off for f32 references."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch import kernels_build
    if kernels_build.find_nvcc() is None:
        pytest.skip("needs nvcc to build the kernels")
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssd import kernel as ssk
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return fk, ssk


def _tol(dtype, f32):
    return f32 if dtype == torch.float32 else 2e-2


def _flash_case(fk, rs, B, Sq, Skv, Hq, Hkv, D, causal, window, dtype,
                offset=0):
    """One flash_fwd launch against its plain version; the launch counts
    show the route: bf16 / f16 on wgmma where D is a multiple of 8 up to
    128 and every tensor starts 16-byte aligned, else on mma.sync; f32 on
    the CUDA cores.  ``offset`` starts q that many elements into its
    allocation."""
    q, k, v = (G(rs.standard_normal(s).astype(np.float32)).to(dtype)
               for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
    if offset:
        q = torch.empty(q.numel() + offset, dtype=dtype,
                        device=q.device)[offset:].view(q.shape).copy_(q)
    n0 = dict(fk.LAUNCHES)
    out, lse = fk.flash_fwd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    tensor_core = dtype != torch.float32
    wgmma = tensor_core and D % 8 == 0 and D <= 128 and \
        q.data_ptr() % 16 == 0
    assert fk.LAUNCHES == {
        "flash_fwd": n0["flash_fwd"] + 1,
        "flash_fwd.wgmma": n0["flash_fwd.wgmma"] + int(wgmma),
        "flash_fwd.mma": n0["flash_fwd.mma"] + int(tensor_core
                                                   and not wgmma)}
    want, wlse = fk.flash_fwd_plain(q, k, v, causal=causal, window=window)
    case = (B, Sq, Skv, Hq, Hkv, D, causal, window, dtype)
    assert out.dtype == dtype and lse.dtype == torch.float32
    # rows with no key under the mask (a window past a short Skv) have no
    # attention to compare: both give finite, block-size dependent numbers,
    # as the reference's kernel does
    live = wlse > -1e29
    assert torch.equal(live, lse > -1e29), case
    assert bool(torch.isfinite(out).all()), case
    if bool(live.any()):
        assert float((out.float() - want.float())[live].abs().max()) < \
            _tol(dtype, 2e-5), case
        assert float((lse - wlse)[live].abs().max()) < \
            _tol(dtype, 1e-4), case


@pytest.mark.parametrize("seed", range(4))
def test_flash_fwd_kernel_matches_plain(mk, seed):
    """Random shapes: head_dim 112 and other non-powers of two, ragged
    lengths, GQA groups, causal / window / non-causal Sq != Skv."""
    fk, _ = mk
    rs = np.random.default_rng(200 + seed)
    for it in range(8):
        B = int(rs.integers(1, 4))
        Hkv = int(rs.choice([1, 2, 4]))
        Hq = Hkv * int(rs.choice([1, 2, 4]))
        D = int(rs.choice([8, 16, 24, 64, 112, 128, 240]))
        causal = bool(rs.random() < 0.7)
        Sq = int(rs.integers(1, 300))
        Skv = Sq if causal else int(rs.integers(1, 300))
        window = int(rs.choice([0, 0, 17, 100]))
        _flash_case(fk, rs, B, Sq, Skv, Hq, Hkv, D, causal, window,
                    _F16[it % 3])


# every edge the tensor-core routes pad or mask, and the serve shapes:
# wgmma at D 8 / 24 / 64 / 112 / 128 (the last box half zero at 8..56 and
# 112), ragged S past a 128-row tile, GQA, a window inside a tile, Sq !=
# Skv with a wholly masked tail; mma.sync at D 240 / 20 / 36 and at a q
# that starts 2 bytes off 16
FLASH_EDGES = [
    # B, Sq, Skv, Hq, Hkv, D, causal, window, dtype
    (2, 130, 130, 4, 2, 8, True, 0, torch.bfloat16),
    (1, 300, 150, 4, 1, 24, True, 40, torch.float16),
    (1, 129, 300, 8, 2, 128, False, 100, torch.bfloat16),
    (4, 2048, 2048, 32, 4, 128, True, 0, torch.bfloat16),
    (4, 2048, 2048, 16, 16, 64, False, 0, torch.bfloat16),
    (1, 100, 100, 2, 2, 24, True, 0, torch.float16),
    (1, 77, 77, 2, 1, 240, True, 0, torch.bfloat16),
    (2, 200, 200, 8, 2, 112, True, 0, torch.float16),
    (1, 190, 190, 8, 2, 64, True, 40, torch.bfloat16),
    (1, 70, 150, 4, 4, 20, False, 0, torch.bfloat16),
    (1, 150, 70, 4, 1, 36, False, 0, torch.float16),
    (1, 65, 65, 2, 2, 112, True, 0, torch.float32),
    (4, 2048, 2048, 32, 32, 112, True, 0, torch.bfloat16),
]


@pytest.mark.parametrize("case", FLASH_EDGES, ids=str)
def test_flash_fwd_kernel_edges(mk, case):
    fk, _ = mk
    _flash_case(fk, np.random.default_rng(7), *case)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_fwd_misaligned_q_takes_mma(mk, dtype):
    """A q whose storage starts one element past 16 bytes is refused by a
    tensor map: the launch takes mma.sync, decided before it, and agrees
    with the plain version."""
    fk, _ = mk
    _flash_case(fk, np.random.default_rng(9), 2, 200, 200, 4, 2, 112, True,
                0, dtype, offset=1)


def _ssd_case(ssk, rs, B, S, H, P, G_, N, chunk, dtype, want=None,
              offset=0):
    """One ssd_scan launch against its plain version; the launch counts
    show the route `ssd_route` gives the case: bf16 on wgmma where its
    shape rule holds and x, B, C and y start 16-byte aligned, other bf16
    on mma.sync, f32 and f16 on the CUDA cores (``want``, when given, is
    the route the case must take).  ``offset`` starts x that many
    elements into its allocation."""
    x = G(rs.standard_normal((B, S, H, P)).astype(np.float32)).to(dtype)
    if offset:
        x = torch.empty(x.numel() + offset, dtype=dtype,
                        device=x.device)[offset:].view(x.shape).copy_(x)
    dt = G(np.logaddexp(rs.standard_normal((B, S, H)), 0)
           .astype(np.float32) * 0.5)
    A = G((-np.exp(rs.standard_normal(H) * 0.3)).astype(np.float32))
    Bm = G((rs.standard_normal((B, S, G_, N)) * 0.5)
           .astype(np.float32)).to(dtype)
    Cm = G((rs.standard_normal((B, S, G_, N)) * 0.5)
           .astype(np.float32)).to(dtype)
    # y comes from the caching allocator, 512-byte aligned
    route = ssk.ssd_route(dtype, P, N, ssk.wgmma_chunk(S, min(chunk, S)),
                          x.data_ptr(), Bm.data_ptr(), Cm.data_ptr())
    if want is not None:
        assert route == want, (route, want)
    n0 = dict(ssk.LAUNCHES)
    y, fin = ssk.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ssk.LAUNCHES == {
        "ssd_scan": n0["ssd_scan"] + 1,
        "ssd_scan.wgmma": n0["ssd_scan.wgmma"] + int(route == "wgmma"),
        "ssd_scan.mma": n0["ssd_scan.mma"] + int(route == "mma")}
    wy, wfin = ssk.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk)
    case = (B, S, H, P, G_, N, chunk, dtype)
    assert y.dtype == dtype and fin.dtype == torch.float32
    tol = 1e-3 if dtype == torch.float32 else 1e-2
    assert float((y.float() - wy.float()).abs().max()) <= \
        tol * max(1.0, float(wy.float().abs().max())), case
    assert float((fin - wfin).abs().max()) <= \
        tol * max(1.0, float(wfin.abs().max())), case


@pytest.mark.parametrize("seed", range(4))
def test_ssd_scan_kernel_matches_plain(mk, seed):
    """Random shapes: ragged S, G > 1, chunks below and above 64 rows,
    P and N up to 128, f32 / bf16 / f16 inputs."""
    _, ssk = mk
    rs = np.random.default_rng(300 + seed)
    for it in range(6):
        B = int(rs.integers(1, 4))
        G_ = int(rs.choice([1, 2]))
        H = G_ * int(rs.choice([1, 2, 4]))
        P = int(rs.choice([8, 16, 32, 64, 128]))
        N = int(rs.choice([8, 16, 64, 128]))
        S = int(rs.integers(1, 400))
        chunk = int(rs.choice([16, 50, 64, 128, 256]))
        _ssd_case(ssk, rs, B, S, H, P, G_, N, chunk, _F16[it % 3])


# every edge the tensor-core route pads or masks, and the serve shape
SSD_EDGES = [
    # B, S, H, P, G, N, chunk, dtype
    (2, 300, 4, 64, 1, 64, 50, torch.bfloat16),
    (1, 130, 2, 8, 1, 8, 64, torch.float16),
    (2, 200, 4, 48, 2, 24, 128, torch.bfloat16),
    (1, 1, 2, 64, 1, 64, 256, torch.bfloat16),
    (1, 700, 2, 100, 2, 128, 1024, torch.float16),
    (1, 90, 2, 20, 1, 40, 32, torch.float32),
    (4, 2048, 112, 64, 1, 64, 256, torch.bfloat16),
]


@pytest.mark.parametrize("case", SSD_EDGES, ids=str)
def test_ssd_scan_kernel_edges(mk, case):
    _, ssk = mk
    _ssd_case(ssk, np.random.default_rng(8), *case)


# bf16 edges the wgmma kernel takes: two rounds of its 8-block cluster,
# S = 1, G = 2 on 5 chunks (3 spare slots), P = N = 128 (to chunk 192),
# mamba2's N = 128 at chunk 256, a lone chunk of S < chunk
SSD_WGMMA_EDGES = [
    # B, S, H, P, G, N, chunk
    (1, 4096, 4, 64, 1, 64, 256),
    (1, 1, 2, 64, 1, 64, 256),
    (2, 320, 4, 32, 2, 16, 64),
    (1, 300, 2, 128, 1, 128, 128),
    (1, 400, 2, 128, 2, 128, 192),
    (1, 600, 2, 64, 1, 128, 256),
    (2, 100, 4, 64, 1, 64, 256),
]


@pytest.mark.parametrize("case", SSD_WGMMA_EDGES, ids=str)
def test_ssd_scan_wgmma_edges(mk, case):
    _, ssk = mk
    _ssd_case(ssk, np.random.default_rng(10), *case, torch.bfloat16,
              want="wgmma")


def test_ssd_scan_misaligned_x_takes_mma(mk):
    """An x whose storage starts one element past 16 bytes is refused by
    a tensor map: the launch takes mma.sync, decided before it, and agrees
    with the plain version."""
    _, ssk = mk
    _ssd_case(ssk, np.random.default_rng(11), 2, 300, 4, 64, 1, 64, 256,
              torch.bfloat16, want="mma", offset=1)


def test_ssd_scan_f16_keeps_large_m_finite(mk):
    """f16 inputs whose M = C B^T exp(segsum) dt exceeds f16's 65504
    inside a chunk (B and C near 40 over N = 64, dt near 1, slow decay)
    while y (x small) and the state fit in f16: the reference keeps M in
    f32, so the kernel must give a finite y within the SSD cases'
    tolerance of its plain version."""
    _, ssk = mk
    rs = np.random.default_rng(65504)
    B, S, H, P, N, chunk = 1, 200, 2, 64, 64, 64
    x = G((rs.standard_normal((B, S, H, P)) * 1e-3).astype(np.float32)) \
        .half()
    dt = G((1.0 + 0.1 * rs.random((B, S, H))).astype(np.float32))
    A = G(np.full(H, -0.01, dtype=np.float32))
    Bm = G((40 + rs.random((B, S, 1, N))).astype(np.float32)).half()
    Cm = G((40 + rs.random((B, S, 1, N))).astype(np.float32)).half()
    cb = torch.einsum("bsn,btn->bst", Cm[:, :, 0].float(),
                      Bm[:, :, 0].float())
    assert float(cb.abs().max()) > 65504.0
    n0 = dict(ssk.LAUNCHES)
    y, fin = ssk.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    wy, wfin = ssk.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk)
    assert bool(torch.isfinite(wy).all()) and \
        float(wy.float().abs().max()) < 65504.0
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(fin).all())
    tol = 1e-2
    assert float((y.float() - wy.float()).abs().max()) <= \
        tol * max(1.0, float(wy.float().abs().max()))
    assert float((fin - wfin).abs().max()) <= \
        tol * max(1.0, float(wfin.abs().max()))
    assert ssk.LAUNCHES == {"ssd_scan": n0["ssd_scan"] + 1,
                            "ssd_scan.wgmma": n0["ssd_scan.wgmma"],
                            "ssd_scan.mma": n0["ssd_scan.mma"]}


def test_reduced_hybrid_model_on_cuda_matches_cpu(mk):
    """zamba2 (reduced, f32) through both kernels on the card against the
    plain versions on the CPU: prefill and decode logits and caches."""
    fk, ssk = mk
    from repro_torch.configs.base import get_config, reduced_config
    from repro_torch.models import model as M
    from repro_torch.models.convert import params_from_reference
    from repro_torch.parallel.sharding import (init_params,
                                               init_params_numpy,
                                               tree_leaves_with_path)
    cfg = reduced_config(get_config("zamba2-7b")).replace(
        dtype="float32", use_pallas=True, attn_impl="flash")
    specs = M.model_param_specs(cfg)
    tree = init_params_numpy(0, specs)
    n_ssd = sum(g.repeat * len(g.layers) for g in cfg.groups)
    n_attn = sum(g.repeat * sum(ls.shared_attn for ls in g.layers)
                 for g in cfg.groups)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32))
    out = {}
    for dev in ("cpu", "cuda"):
        params = params_from_reference(tree, specs, device=dev)
        caches = init_params(0, M.cache_specs_tree(cfg, 2, 48), device=dev)
        n0 = (fk.LAUNCHES["flash_fwd"], ssk.LAUNCHES["ssd_scan"])
        with torch.no_grad():
            last, caches = M.prefill(
                cfg, params, {"tokens": toks[:, :36].to(dev)}, caches)
            logits = [last.cpu()]
            for i in range(36, 40):
                lg, caches = M.decode_step(
                    cfg, params, {"tokens": toks[:, i:i + 1].to(dev)},
                    caches)
                logits.append(lg.cpu())
        launched = (fk.LAUNCHES["flash_fwd"] - n0[0],
                    ssk.LAUNCHES["ssd_scan"] - n0[1])
        assert launched == ((n_attn, n_ssd) if dev == "cuda" else (0, 0))
        out[dev] = (torch.stack(logits), {k: v.cpu() for k, v in
                                          tree_leaves_with_path(caches)})
    (lc, cc), (lg, cg) = out["cpu"], out["cuda"]
    assert float((lc - lg).abs().max()) <= 1e-4 * float(lc.abs().max())
    for name, t in cc.items():
        assert float((t.float() - cg[name].float()).abs().max()) <= \
            1e-4 * max(1.0, float(t.float().abs().max())), name


# ------------------------- the training slice ---------------------------- #
def _rel_l2(a, b):
    return float((a.double() - b.double()).norm()
                 / b.double().norm().clamp_min(1e-30))


@pytest.mark.parametrize("seed", range(3))
def test_ssd_scan_function_grads_on_cuda_match_cpu(mk, seed):
    """`SSDScan` on the card (the kernel forward, the chunked scan's
    backward) against the same Function on the CPU (the plain forward),
    f32 and bf16, through y and the final state; every input's gradient,
    with the kernel launched once for the forward."""
    _, ssk = mk
    from repro_torch.kernels.ssd.ops import ssd
    rs = np.random.default_rng(700 + seed)
    for dtype in (torch.float32, torch.bfloat16):
        B, G_ = int(rs.integers(1, 3)), int(rs.choice([1, 2]))
        H, P, N = G_ * int(rs.choice([1, 2])), int(rs.choice([16, 64])), 16
        S, chunk = int(rs.integers(1, 300)), int(rs.choice([32, 64, 256]))
        x = rs.standard_normal((B, S, H, P)).astype(np.float32)
        dt = (rs.random((B, S, H)) * 0.5 + 0.01).astype(np.float32)
        A = -np.exp(rs.standard_normal(H)).astype(np.float32)
        Bm = rs.standard_normal((B, S, G_, N)).astype(np.float32)
        Cm = rs.standard_normal((B, S, G_, N)).astype(np.float32)
        wy = torch.from_numpy(rs.standard_normal((B, S, H, P)).astype(
            np.float32))
        grads = {}
        for dev in ("cpu", "cuda"):
            ins = [torch.from_numpy(a).to(dev) for a in (x, dt, A, Bm, Cm)]
            ins = [t.to(dtype) if i in (0, 3, 4) else t
                   for i, t in enumerate(ins)]
            ins = [t.requires_grad_() for t in ins]
            n0 = ssk.LAUNCHES["ssd_scan"]
            y, fin = ssd(*ins, chunk=chunk, impl="pallas")
            (torch.sum(y.float() * wy.to(dev)) + fin.sin().sum()).backward()
            assert ssk.LAUNCHES["ssd_scan"] - n0 == (dev == "cuda")
            grads[dev] = [t.grad.cpu() for t in ins]
        tol = 1e-4 if dtype == torch.float32 else 3e-2
        for name, a, b in zip("x dt A B C".split(), grads["cuda"],
                              grads["cpu"]):
            assert a.dtype == b.dtype, name
            assert _rel_l2(a, b) <= tol, (name, dtype, _rel_l2(a, b))


@pytest.mark.parametrize("seed", range(3))
def test_flash_backward_on_cuda_matches_cpu(mk, seed):
    """`FlashAttention` with the kernel forward on the card against the
    plain forward on the CPU, both through `brick_bwd`: GQA, causal,
    window and ragged S, f32 and bf16."""
    fk, _ = mk
    from repro_torch.kernels.flash_attention.ops import flash_attention
    rs = np.random.default_rng(800 + seed)
    for dtype in (torch.float32, torch.bfloat16):
        B, Hkv = int(rs.integers(1, 3)), int(rs.choice([1, 2]))
        Hq, D = Hkv * int(rs.choice([1, 4])), int(rs.choice([16, 64, 112]))
        S = int(rs.integers(1, 300))
        window = int(rs.choice([0, 0, 37]))
        cq, ck = int(rs.choice([32, 64])), int(rs.choice([32, 128]))
        qkv = [rs.standard_normal(s).astype(np.float32)
               for s in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))]
        wo = torch.from_numpy(rs.standard_normal((B, S, Hq, D)).astype(
            np.float32))
        grads = {}
        for dev in ("cpu", "cuda"):
            ins = [torch.from_numpy(a).to(dev).to(dtype).requires_grad_()
                   for a in qkv]
            n0 = fk.LAUNCHES["flash_fwd"]
            out = flash_attention(*ins, True, window, cq, ck, "pallas")
            torch.sum(out.float() * wo.to(dev)).backward()
            assert fk.LAUNCHES["flash_fwd"] - n0 == (dev == "cuda")
            grads[dev] = [t.grad.cpu() for t in ins]
        tol = 1e-4 if dtype == torch.float32 else 3e-2
        for name, a, b in zip("qkv", grads["cuda"], grads["cpu"]):
            assert a.dtype == dtype, name
            assert _rel_l2(a, b) <= tol, (name, dtype, _rel_l2(a, b))


def test_kernel_launches_refuse_grad_outside_their_function(mk):
    """A launch on inputs that require grad, with grad mode on, would give
    outputs with no grad_fn: it raises, and launches nothing."""
    fk, ssk = mk
    x = torch.randn(1, 64, 2, 16, device="cuda", requires_grad=True)
    dt = torch.rand(1, 64, 2, device="cuda")
    A = -torch.rand(2, device="cuda")
    Bm = torch.randn(1, 64, 1, 16, device="cuda")
    n0 = dict(ssk.LAUNCHES)
    with pytest.raises(RuntimeError, match="requires grad"):
        ssk.ssd_scan(x, dt, A, Bm, Bm.clone(), chunk=32)
    q = torch.randn(1, 64, 2, 16, device="cuda", requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        fk.flash_fwd(q, q.detach(), q.detach())
    assert ssk.LAUNCHES == n0
    with torch.no_grad():
        ssk.ssd_scan(x, dt, A, Bm, Bm.clone(), chunk=32)
    assert ssk.LAUNCHES["ssd_scan"] == n0["ssd_scan"] + 1


def test_reduced_train_step_on_cuda_matches_cpu(mk):
    """A reduced zamba2 train step (f32, the kernels, remat "full") on the
    card against the same step on the CPU: loss, every gradient (relative
    L2, 1e-3: twenty times what one ulp of the weights moves them on the
    CPU) and the kernels' launches, forward and recompute."""
    fk, ssk = mk
    from repro_torch.configs.base import get_config, reduced_config
    from repro_torch.models import model as M
    from repro_torch.models.convert import params_from_reference
    from repro_torch.parallel.sharding import (init_params_numpy,
                                               tree_leaves_with_path)
    from repro_torch.training.train_state import loss_and_grads
    cfg = reduced_config(get_config("zamba2-7b")).replace(
        dtype="float32", use_pallas=True, attn_impl="flash", remat="full",
        loss_chunk=16)
    specs = M.model_param_specs(cfg)
    tree = init_params_numpy(0, specs)
    # the shared attention at a fan-in of d_model (chip_smoke.py's
    # condition_attention): with the reference's rank-3 fan-in, one ulp
    # of the weights moves this model's gradients ~2e-3 (L2), the bound
    a = tree["shared_attn"]["attn"]
    for name in ("wq", "wk", "wv"):
        a[name] *= np.float32((cfg.shared_attn_heads / cfg.d_model) ** 0.5)
    a["wo"] *= np.float32((1.0 / cfg.shared_attn_heads) ** 0.5)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                             (2, 65)).astype(np.int32)
    n_ssd = sum(g.repeat * len(g.layers) for g in cfg.groups)
    n_attn = sum(g.repeat * sum(ls.shared_attn for ls in g.layers)
                 for g in cfg.groups)
    out = {}
    for dev in ("cpu", "cuda"):
        params = params_from_reference(tree, specs, device=dev)
        batch = {"tokens": torch.from_numpy(toks[:, :-1]).to(dev),
                 "labels": torch.from_numpy(toks[:, 1:]).to(dev)}
        n0 = (fk.LAUNCHES["flash_fwd"], ssk.LAUNCHES["ssd_scan"])
        m, g = loss_and_grads(cfg, params, batch)
        launched = (fk.LAUNCHES["flash_fwd"] - n0[0],
                    ssk.LAUNCHES["ssd_scan"] - n0[1])
        assert launched == ((2 * n_attn, 2 * n_ssd) if dev == "cuda"
                            else (0, 0))
        out[dev] = (float(m["loss"]), {p: x.cpu() for p, x in
                                       tree_leaves_with_path(g)})
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    assert abs(lc - lg) <= 1e-5 * abs(lc)
    for p, a in gc.items():
        assert float(gg[p].norm()) > 0 or float(a.norm()) == 0, p
        assert _rel_l2(gg[p], a) <= 1e-3, (p, _rel_l2(gg[p], a))
