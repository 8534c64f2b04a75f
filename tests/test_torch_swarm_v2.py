"""The redesigned swarm pump of `repro_torch` on the CPU: the ragged
(CSR) matcher against the reference's `match_requests_np`, an emulation
of the card's matcher (each lane's candidates sorted, first-set-bit
steps, a warp minimum) and of the fused order kernel (a
bitonic sort of (key, index) pairs) against the plain versions and the
reference, and the hub's one matcher call per pump.  Inputs are made from
a seed with numpy and handed to both packages; every comparison is
exact."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import swarm_kernels as ref  # noqa: E402
from repro_torch.core import swarm_kernels as sk  # noqa: E402

INT64_MAX = np.iinfo(np.int64).max


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(autouse=True)
def _no_launch_on_cpu():
    before = dict(sk.LAUNCHES)
    yield
    assert sk.LAUNCHES == before


# ============================ CSR cases ================================= #
def _csr_case(rs, R, P, N, max_deg, key_range=1 << 26):
    """Ragged rows: degrees 0..max_deg (half of them <= 16), duplicate
    holders, unusable slots, order rows read through a permutation, walks
    and budgets past both ends."""
    deg = np.where(rs.random(R) < 0.5, rs.integers(0, 17, R),
                   rs.integers(0, max_deg + 1, R))
    ptr = np.zeros(R + 1, dtype=np.int64)
    np.cumsum(deg, out=ptr[1:])
    nnz = int(ptr[-1])
    O = R + 3
    return dict(
        orders=np.stack([rs.permutation(P) for _ in range(O)])
        .astype(np.int32),
        row_of=rs.permutation(O)[:R].astype(np.int32),
        cand_ptr=ptr.astype(np.int32),
        cand=rs.integers(0, N, nnz).astype(np.int32),
        cand_ok=rs.random(nnz) < 0.8,
        cand_key=rs.integers(0, key_range, nnz).astype(np.int32),
        n_walk=rs.integers(-1, P + 2, R).astype(np.int32),
        budgets=rs.integers(-1, 9, R).astype(np.int32),
        have=rs.random((N, P)) < rs.choice([0.05, 0.3, 0.7]),
        full=rs.random(N) < 0.03)


def _dense(case):
    """The CSR rows padded to the reference's dense form."""
    ptr = case["cand_ptr"].astype(np.int64)
    R = ptr.size - 1
    deg = np.diff(ptr)
    C = int(deg.max()) if R else 0
    cand = np.full((R, C), -1, dtype=np.int32)
    ok = np.zeros((R, C), dtype=bool)
    key = np.full((R, C), ref.KEY_INF32, dtype=np.int32)
    for r in range(R):
        sl = slice(ptr[r], ptr[r + 1])
        cand[r, :deg[r]] = case["cand"][sl]
        ok[r, :deg[r]] = case["cand_ok"][sl]
        key[r, :deg[r]] = case["cand_key"][sl]
    return cand, ok, key


def _reference(case):
    cand, ok, key = _dense(case)
    return ref.match_requests_np(case["orders"][case["row_of"]],
                                 case["n_walk"], case["budgets"], cand, ok,
                                 key, case["have"], case["full"])


_ARGS = ("orders", "row_of", "cand_ptr", "cand", "cand_ok", "cand_key",
         "n_walk", "budgets", "have", "full")


def _ragged(fn, case):
    return fn(*(T(case[k]) for k in _ARGS))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("P", [1, 7, 64, 100])
def test_ragged_plain_matches_reference(P, seed):
    rs = np.random.default_rng(1000 * P + seed)
    picked = 0
    for key_range in (1 << 26, 3):          # distinct keys, then ties
        case = _csr_case(rs, 20, P, 700, 600, key_range)
        want = _reference(case)
        got = _ragged(sk.match_requests_ragged, case)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(
            _ragged(sk.match_requests_ragged_plain, case).numpy(), want)
        picked += int((want >= 0).sum())
    assert picked > 0


def test_ragged_rows_without_candidates_or_budget():
    """Degree 0, every slot unusable, budget <= 0 and walk <= 0 stop
    exactly where the reference stops."""
    rs = np.random.default_rng(5)
    case = _csr_case(rs, 12, 16, 40, 9)
    case["cand_ptr"][1:4] = 0               # rows 0..2: degree 0
    case["cand_ok"][case["cand_ptr"][5]:case["cand_ptr"][6]] = False
    case["budgets"][6] = 0
    case["budgets"][7] = -3
    case["n_walk"][8] = 0
    case["n_walk"][9] = -2
    want = _reference(case)
    got = _ragged(sk.match_requests_ragged, case).numpy()
    assert np.array_equal(got, want)
    assert (got[[0, 1, 2, 5, 6, 7, 8, 9]] == -1).all()


# ============== the card's matcher, emulated step for step =============== #
# The kernel packs (key, c) as the unsigned word (key ^ 2^31) << 32 | c;
# with its top bit flipped, that is the signed int64 key << 32 | c, so the
# emulation orders signed int64 words, and the empty word ~0 is INT64_MAX.
_NONE = INT64_MAX
_REG_MAX_DEGREE = 512


def _bitonic(w, n):
    """The kernel's bitonic network over the last dimension of ``w`` (n
    words, each lane's slots): the lower element of an ascending pair
    keeps the smaller word."""
    e = torch.arange(n)
    k = 2
    while k <= n:
        j = k >> 1
        while j > 0:
            o = w[..., e ^ j]
            asc = (e & k) == 0
            lower = (e & j) == 0
            w = torch.where(lower == asc, torch.minimum(w, o),
                            torch.maximum(w, o))
            j >>= 1
        k <<= 1
    return w


def _nonzero_bytes(x):
    """The kernel's byte -> bit packing: the top bit of each byte of y is
    set where the byte is not zero, then a multiply gathers the four top
    bits into bits 28..31 (32-bit arithmetic)."""
    y = ((((x & 0x7F7F7F7F) + 0x7F7F7F7F) | x) & 0x80808080) & 0xFFFFFFFF
    return (((y >> 7) * 0x10204080) & 0xFFFFFFFF) >> 28


def _row_words(case, r):
    ptr = case["cand_ptr"]
    start, deg = int(ptr[r]), int(ptr[r + 1] - ptr[r])
    key = case["cand_key"][start:start + deg].astype(np.int64)
    ok = case["cand_ok"][start:start + deg]
    words = [(int(key[c]) << 32) | c if ok[c] else _NONE for c in range(deg)]
    cand = case["cand"][start:start + deg].astype(np.int64)
    return deg, torch.tensor(words, dtype=torch.int64), torch.from_numpy(cand)


def _masks(case, cj, valid):
    safe = cj.clamp(min=0)
    have = torch.from_numpy(case["have"])
    full = torch.from_numpy(case["full"])
    return (have[safe] | full[safe][..., None]) & valid[..., None]


def _emulate_row(case, r, S):
    """Register route: one row on a warp, S slots a lane."""
    P = case["orders"].shape[1]
    walk = min(max(int(case["n_walk"][r]), 0), P)
    budget = int(case["budgets"][r])
    deg, words, cand = _row_words(case, r)
    # lane l, slot s loads candidate c = s * 32 + l
    c_of = torch.arange(S)[None, :] * 32 + torch.arange(32)[:, None]
    w = torch.where(c_of < deg, words[c_of.clamp(max=max(deg - 1, 0))]
                    if deg else torch.full_like(c_of, _NONE),
                    torch.full_like(c_of, _NONE))              # (32, S)
    n_free = int((w != _NONE).sum())
    w = _bitonic(w, S)          # each lane's slots alone
    assert bool((w[:, 1:] >= w[:, :-1]).all())
    valid = w != _NONE
    c = torch.where(valid, w & 0xFFFFFFFF, torch.zeros_like(w))
    cj = torch.where(valid, cand[c] if deg else c, -1)
    m = _masks(case, cj, valid)                                # (32, S, P)
    # the order: lane l holds positions l and l + 32
    orow = case["orders"][case["row_of"][r]]
    ords = [[int(orow[q]) if q < P else 0 for q in (lane, lane + 32)]
            for lane in range(32)]
    picks = torch.full((P,), -1, dtype=torch.int32)
    for k in range(walk):
        if budget <= 0 or n_free <= 0:
            break
        p = ords[k & 31][0 if k < 32 else 1]
        local = m[:, :, p]                           # lanes x slots
        first = torch.where(local.any(1), local.int().argmax(1), -1)
        # the smallest of the lanes' first hits
        wv = torch.where(first >= 0, w[torch.arange(32), first.clamp(min=0)],
                         _NONE)
        if not bool((wv != _NONE).any()):
            continue
        wl = int(torch.argmin(wv))
        ws = int(first[wl])
        picks[k] = int(cj[wl, ws])
        m[wl, ws] = False
        budget -= 1
        n_free -= 1
    return picks


def _emulate_wide(case, r):
    """Wide route: each step scans every candidate's word and mask and
    takes the smallest available word; a pick empties the word."""
    P = case["orders"].shape[1]
    walk = min(max(int(case["n_walk"][r]), 0), P)
    budget = int(case["budgets"][r])
    deg, words, cand = _row_words(case, r)
    m = _masks(case, cand, torch.ones(deg, dtype=torch.bool))
    orow = case["orders"][case["row_of"][r]]
    n_free = int((words != _NONE).sum())
    picks = torch.full((P,), -1, dtype=torch.int32)
    for k in range(walk):
        if budget <= 0 or n_free <= 0:
            break
        hit = m[:, int(orow[k])] & (words != _NONE)
        if not bool(hit.any()):
            continue
        c = int(torch.where(hit, words, _NONE).argmin())
        picks[k] = int(cand[c])
        words[c] = _NONE
        budget -= 1
        n_free -= 1
    return picks


def _emulate(case):
    """The kernel's routes: a warp a row with ceil(degree / 32) slots a
    lane, rounded to a power of two; P > 64 or degree > 512 takes the
    wide route."""
    ptr = case["cand_ptr"]
    R = ptr.size - 1
    P = case["orders"].shape[1]
    out = torch.full((R, P), -1, dtype=torch.int32)
    deg = np.diff(ptr.astype(np.int64))
    for r in range(R):
        if P > 64 or deg[r] > _REG_MAX_DEGREE:
            out[r] = _emulate_wide(case, r)
        else:
            S = 1 << max(int(np.ceil(deg[r] / 32)) - 1, 0).bit_length()
            out[r] = _emulate_row(case, r, S)
    return out


def test_nonzero_bytes_packing():
    rs = np.random.default_rng(3)
    for mask in range(16):
        for _ in range(8):
            x = 0
            for b in range(4):
                if mask >> b & 1:
                    x |= int(rs.choice([1, 0x80, 0xFF,
                                        rs.integers(1, 256)])) << (8 * b)
            assert _nonzero_bytes(x) == mask


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("P", [1, 7, 64, 100])
def test_v2_walk_emulation_matches_plain(P, seed):
    rs = np.random.default_rng(2000 * P + seed)
    for key_range, max_deg in ((1 << 26, 600), (3, 40), (1 << 20, 16)):
        case = _csr_case(rs, 16, P, 700, max_deg, key_range)
        want = _ragged(sk.match_requests_ragged_plain, case)
        assert torch.equal(_emulate(case), want)
        assert np.array_equal(want.numpy(), _reference(case))


def test_v2_emulation_covers_every_lane_layout():
    """Rows of 0..512 candidates: S = 1, 2, 4, 8 and 16 slots a lane."""
    rs = np.random.default_rng(11)
    for degs in ([8, 3, 0, 8], [16, 9, 12, 1], [17, 33, 65, 129],
                 [257, 512, 32, 64]):
        case = _csr_case(rs, 4, 64, 900, 1)
        ptr = np.zeros(5, dtype=np.int64)
        np.cumsum(degs, out=ptr[1:])
        nnz = int(ptr[-1])
        case.update(cand_ptr=ptr.astype(np.int32),
                    cand=rs.integers(0, 900, nnz).astype(np.int32),
                    cand_ok=rs.random(nnz) < 0.9,
                    cand_key=rs.integers(0, 50, nnz).astype(np.int32),
                    n_walk=np.full(4, 64, dtype=np.int32),
                    budgets=np.full(4, 40, dtype=np.int32))
        want = _reference(case)
        assert torch.equal(_emulate(case), torch.from_numpy(want))
        assert int((want >= 0).sum()) > 0


# ===================== fused orders: a pair sort ========================= #
def _pair_sort_emulation(keys):
    """The fused kernel on one row: (key, index) pairs padded to a power
    of two (64 on the kernel's warp route) with (INT64_MAX, index >= n),
    sorted by the bitonic network; returns the indices of the first n.
    Wider rows show the pair sort is the stable sort at any width."""
    n = keys.shape[0]
    n2 = 64 if n <= 64 else 1 << (n - 1).bit_length()
    k = torch.full((n2,), INT64_MAX, dtype=torch.int64)
    k[:n] = keys
    idx = torch.arange(n2)
    e = torch.arange(n2)
    size = 2
    while size <= n2:
        j = size >> 1
        while j > 0:
            f = e ^ j
            ok_, oi = k[f], idx[f]
            other_first = (ok_ < k) | ((ok_ == k) & (oi < idx))
            take = other_first == (((e & j) == 0) == ((e & size) == 0))
            k = torch.where(take, ok_, k)
            idx = torch.where(take, oi, idx)
            j >>= 1
        size <<= 1
    return idx[:n].to(torch.int32)


@pytest.mark.parametrize("P", [1, 63, 64, 65, 300])
def test_fused_orders_pair_sort_matches_reference(P):
    rs = np.random.default_rng(P)
    R = 9
    counts = rs.integers(0, 50, P).astype(np.int64)
    offsets = rs.integers(0, 10_000, R).astype(np.int64)
    # mostly held: many KEY_INF ties, which must come out in index order
    missing = rs.random((R, P)) < 0.3
    missing[0] = False
    pc = rs.choice(np.array([0, 1, 15, 64]), (R, P)).astype(np.int64)
    want_r = ref.rarest_orders(missing, counts, offsets, P, backend="numpy")
    want_c = ref.cost_orders(missing, counts, offsets, pc, P,
                             backend="numpy")
    span = (int(counts.max()) + 1) * P * P
    for want, cost, sp in ((want_r, None, 0), (want_c, pc, span)):
        keys = sk.rarest_keys_plain(T(counts), T(offsets), P,
                                    missing=T(missing),
                                    piece_cost=None if cost is None
                                    else T(cost), span=sp)
        got = torch.stack([_pair_sort_emulation(row) for row in keys])
        assert np.array_equal(got.numpy(), want)
        plain = sk.rarest_orders_plain(T(counts), T(offsets), P,
                                       missing=T(missing),
                                       piece_cost=None if cost is None
                                       else T(cost), span=sp)
        assert np.array_equal(plain.numpy(), want)
    assert np.array_equal(
        sk.rarest_orders(T(missing), T(counts), T(offsets), P).numpy(),
        want_r)
    assert np.array_equal(
        sk.cost_orders(T(missing), T(counts), T(offsets), T(pc), P).numpy(),
        want_c)


def test_routes_follow_the_shapes():
    assert [sk._orders_route(n) for n in (1, 64, 65, 4097)] == \
        ["warp", "warp", "sort", "sort"]
    assert sk._match_route(64, 512) == "reg"
    assert sk._match_route(64, 513) == "wide"
    assert sk._match_route(65, 1) == "wide"


# ================== the hub: one matcher call per pump =================== #
def test_hub_makes_one_matcher_call_per_pump(monkeypatch):
    from repro_torch.core import swarm_arrays as sa
    from repro_torch.scenarios import scenario_vii
    calls = []
    real_match = sa.match_requests_ragged

    def counting(*a, **kw):
        calls.append(1)
        return real_match(*a, **kw)

    pumps = []
    real_fast = sa.SwarmHub._match_fast

    def fast(self, st, rows, fast_rows, *rest):
        deg = st.ub_n[rows[fast_rows]].copy()
        n0 = len(calls)
        real_fast(self, st, rows, fast_rows, *rest)
        pumps.append((deg, len(calls) - n0))

    monkeypatch.setattr(sa, "match_requests_ragged", counting)
    monkeypatch.setattr(sa.SwarmHub, "_match_fast", fast)
    res = scenario_vii(verbose=False, n_volunteers=64, batched=True,
                       device="cpu")
    assert res["done"] and res["replicated"]
    assert all(n == int((deg > 0).any()) for deg, n in pumps)
    assert sum(n for _, n in pumps) > 20
    # pumps whose rows spread over several of the old degree buckets
    # (<= 8, <= 32, ...) still made one call
    assert any(n == 1 and deg.min() <= 8 < deg.max() for deg, n in pumps)
