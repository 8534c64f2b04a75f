"""`repro_torch.core.swarm_kernels` on CPU tensors against the reference
`repro.core.swarm_kernels`: the numpy backend exactly, for every function
of the module, and the Pallas kernels (interpret mode) inside the int32
domain they are valid for.  Inputs are made from a seed with numpy and
handed to both packages."""
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import rarest_first_order_np  # noqa: E402
from repro.core import swarm_kernels as ref  # noqa: E402
from repro_torch.core import swarm_kernels as sk  # noqa: E402
from tests.test_swarm_batch import (_holder_topk_scalar,  # noqa: E402
                                    _match_requests_scalar,
                                    _random_match_case)

SEEDS = [0, 1, 2, 3]


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rarest_case(rng, max_pieces=100, max_rows=12, max_count=7):
    n_pieces = rng.randrange(1, max_pieces)
    n_rows = rng.randrange(1, max_rows)
    counts = np.array([rng.randrange(0, max_count)
                       for _ in range(n_pieces)], dtype=np.int32)
    missing = np.array([[rng.random() < 0.5 for _ in range(n_pieces)]
                        for _ in range(n_rows)], dtype=bool)
    offsets = np.array([rng.randrange(0, 2000) for _ in range(n_rows)],
                       dtype=np.int64)
    return n_pieces, counts, missing, offsets


def _island_case(rng):
    n = rng.randrange(1, 30)
    p = rng.randrange(1, 40)
    k = rng.randrange(1, 6)
    have = np.array([[rng.random() < 0.2 for _ in range(p)]
                     for _ in range(n)], dtype=bool)
    island = np.array([rng.randrange(k) for _ in range(n)])
    member = np.zeros((k, n), dtype=bool)
    member[island, np.arange(n)] = True
    cost = np.array([[0 if a == b else rng.randrange(1, 16)
                      for b in range(k)] for a in range(k)], dtype=np.int64)
    return have, member, cost


@pytest.fixture(autouse=True)
def _no_launch_on_cpu():
    """Every call in this file takes the plain path: no launch counted."""
    before = dict(sk.LAUNCHES)
    yield
    assert sk.LAUNCHES == before


# ====================== numpy backend, exactly ========================== #
@pytest.mark.parametrize("seed", SEEDS)
def test_rarest_keys_and_orders_match_numpy(seed):
    rng = random.Random(100 + seed)
    for _ in range(15):
        n, counts, missing, offsets = _rarest_case(rng)
        keys = sk.rarest_keys(T(counts), T(offsets), n)
        assert keys.dtype == torch.int64
        assert np.array_equal(keys.numpy(),
                              ref.rarest_keys_np(counts, offsets, n))
        got = sk.rarest_orders(T(missing), T(counts), T(offsets), n)
        want = ref.rarest_orders(missing, counts, offsets, n,
                                 backend="numpy")
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)


def test_rarest_orders_match_scalar_per_row():
    rng = random.Random(11)
    for _ in range(30):
        n, counts, missing, offsets = _rarest_case(rng)
        orders = sk.rarest_orders(T(missing), T(counts), T(offsets), n)
        for r in range(missing.shape[0]):
            k = int(missing[r].sum())
            want = rarest_first_order_np(
                sorted(np.nonzero(missing[r])[0].tolist()), counts,
                offset=int(offsets[r]), n_pieces=n)
            assert orders[r, :k].tolist() == want


@pytest.mark.parametrize("seed", SEEDS)
def test_cost_orders_match_numpy(seed):
    rng = random.Random(200 + seed)
    for _ in range(15):
        n, counts, missing, offsets = _rarest_case(rng)
        pc = np.array([[rng.choice([0, 1, 5, 15, 64]) for _ in range(n)]
                       for _ in range(missing.shape[0])], dtype=np.int64)
        want_keys = ref.cost_rarest_keys(counts, offsets, pc, n,
                                         backend="numpy")
        got_keys = sk.cost_rarest_keys(T(counts), T(offsets), T(pc), n)
        assert np.array_equal(got_keys.numpy(), want_keys)
        want = ref.cost_orders(missing, counts, offsets, pc, n,
                               backend="numpy")
        got = sk.cost_orders(T(missing), T(counts), T(offsets), T(pc), n,
                             max_count=int(counts.max()))
        assert np.array_equal(got.numpy(), want)


def test_cost_orders_above_int32_match_numpy():
    """N=10,000-scale counts, P=64 and costs up to COST_NONE put the keys
    above 2^31: the port keeps int64 and matches numpy, where the Pallas
    scoring kernel's int32 domain (counts * P^2 < 2^31) ends."""
    rs = np.random.default_rng(7)
    n, rows = 64, 40
    counts = rs.integers(0, 10_001, n).astype(np.int32)
    counts[3] = 10_000
    offsets = rs.integers(0, 5_000, rows).astype(np.int64)
    missing = rs.random((rows, n)) < 0.7
    pc = rs.choice(np.array([0, 3, 15, 64]), size=(rows, n)).astype(np.int64)
    want_keys = ref.cost_rarest_keys(counts, offsets, pc, n, backend="numpy")
    assert want_keys.max() > 2 ** 31
    got_keys = sk.cost_rarest_keys(T(counts), T(offsets), T(pc), n)
    assert np.array_equal(got_keys.numpy(), want_keys)
    got = sk.cost_orders(T(missing), T(counts), T(offsets), T(pc), n)
    assert np.array_equal(got.numpy(),
                          ref.cost_orders(missing, counts, offsets, pc, n,
                                          backend="numpy"))


# (cap, n, P, K, R, p_alive, p_full, empty islands, max cost)
COST_ROWS_CASES = {
    "ragged_rows": (64, 37, 33, 5, 13, 1.0, 0.0, 0, 16),
    "dead_rows": (80, 70, 64, 8, 70, 0.6, 0.0, 0, 16),
    "full_rows": (50, 50, 40, 4, 29, 0.8, 0.25, 0, 16),
    "empty_island": (40, 33, 17, 6, 20, 0.9, 0.1, 2, 16),
    "one_island": (32, 30, 65, 1, 30, 0.9, 0.1, 0, 16),
    "no_rows": (8, 0, 20, 3, 0, 1.0, 0.0, 0, 16),
    "costs_above_none": (70, 61, 100, 7, 61, 0.9, 0.05, 1, 200),
}


def _cost_rows_case(name, seed):
    """The hub's planes (rows past n hold junk the reduction must skip),
    leecher rows in any order with repeats, and a (K, K) cost matrix."""
    cap, n, P, K, R, p_alive, p_full, empty, max_cost = \
        COST_ROWS_CASES[name]
    rs = np.random.default_rng(seed)
    have = rs.random((cap, P)) < rs.choice([0.02, 0.2])
    full = rs.random(cap) < p_full
    alive = rs.random(cap) < p_alive
    island = rs.integers(0, K - empty, cap).astype(np.int64)
    rows = rs.choice(max(n, 1), R).astype(np.int64)
    cost = rs.integers(0, max_cost, (K, K)).astype(np.int64)
    np.fill_diagonal(cost, 0)
    return have, full, alive, island, n, rows, cost


def _cost_rows_reference(have, full, alive, island, n, rows, cost,
                         backend="numpy"):
    """The reference hub's composition (`SwarmHub._piece_cost`)."""
    h = (have[:n] | full[:n, None]) & alive[:n, None]
    member = np.zeros((cost.shape[0], n), dtype=bool)
    member[island[:n], np.arange(n)] = True
    avail = (ref.island_has_np(h, member) if backend == "numpy"
             else ref.island_has(h, member, backend=backend))
    return ref.min_island_cost(avail, cost)[island[rows]]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", sorted(COST_ROWS_CASES))
def test_island_cost_rows_matches_reference_composition(case, seed):
    """The fused P4P cost rows against the reference's island_has_np +
    min_island_cost + gather, and against the port's own composition
    (the alive plane, `island_has`, `min_island_cost`, the gather)."""
    args = _cost_rows_case(case, 1000 + seed)
    want = _cost_rows_reference(*args)
    have, full, alive, island, n, rows, cost = args
    planes = (T(have.astype(np.uint8)), T(full.astype(np.uint8)),
              T(alive.astype(np.uint8)), T(island))
    for fn in (sk.island_cost_rows_plain, sk.island_cost_rows):
        got = fn(*planes, n, T(rows), T(cost))
        assert got.dtype == torch.int64 and got.shape == want.shape
        assert np.array_equal(got.numpy(), want), (case, fn.__name__)
    h, f, a, isl = planes
    alive_plane = (h[:n] | f[:n, None]) & a[:n, None]
    member = torch.zeros((cost.shape[0], n), dtype=torch.uint8)
    member[isl[:n], torch.arange(n)] = 1
    composed = sk.min_island_cost(sk.island_has(alive_plane, member),
                                  T(cost))[isl[T(rows)]]
    assert np.array_equal(composed.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_island_has_and_min_island_cost_match_numpy(seed):
    rng = random.Random(300 + seed)
    for _ in range(15):
        have, member, cost = _island_case(rng)
        want = ref.island_has_np(have, member)
        got = sk.island_has(T(have), T(member))
        assert got.dtype == torch.bool
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(sk.island_has_plain(T(have), T(member))
                              .numpy(), want)
        assert np.array_equal(sk.min_island_cost(got, T(cost)).numpy(),
                              ref.min_island_cost(want, cost))


@pytest.mark.parametrize("seed", SEEDS)
def test_choke_order_matches_numpy(seed):
    rng = random.Random(400 + seed)
    rates = [0.0, 0.0, 1.5, 7.25, 7.25, 100.0]
    for trial in range(20):
        c = rng.randrange(1, 20)
        h = rng.randrange(1, 10)
        recv = np.array([[rng.choice(rates) for _ in range(c)]
                         for _ in range(h)], dtype=np.float32)
        sent = np.array([[rng.choice(rates) for _ in range(c)]
                         for _ in range(h)], dtype=np.float32)
        cand = np.array([[rng.random() < 0.6 for _ in range(c)]
                         for _ in range(h)], dtype=bool)
        if trial % 2:
            # P4P: a per-holder (H, C) cost * 2^20 + rank key
            ranks = np.array([[rng.randrange(0, 4) * 2 ** 20 + j
                               for j in range(c)] for _ in range(h)],
                             dtype=np.int64)
        else:
            ranks = np.array(rng.sample(range(c), c), dtype=np.int64)
        got = sk.choke_order(T(recv), T(sent), T(cand), T(ranks))
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(),
                              ref.choke_order_np(recv, sent, cand, ranks))


@pytest.mark.parametrize("seed", SEEDS)
def test_match_requests_matches_numpy_and_scalar(seed):
    rng = random.Random(500 + seed)
    picked = 0
    for _ in range(25):
        case = _random_match_case(rng)
        want = ref.match_requests_np(*case)
        got = sk.match_requests(*map(T, case))
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(got.numpy(), _match_requests_scalar(*case))
        plain = sk.match_requests_plain(*map(T, case))
        assert np.array_equal(plain.numpy(), want)
        picked += int((want >= 0).sum())
    assert picked > 20


def test_match_requests_hub_shapes_match_numpy():
    """Hub-shaped cases: uint8 planes, a wide candidate bucket, int32
    keys cost * 2^20 + rank, every row's order a permutation."""
    rs = np.random.default_rng(17)
    R, P, N, C = 30, 64, 200, 128
    orders = np.stack([rs.permutation(P) for _ in range(R)]).astype(np.int32)
    n_walk = rs.integers(0, P + 1, R).astype(np.int32)
    budgets = rs.integers(0, 8, R).astype(np.int32)
    cand = np.stack([rs.choice(N, C, replace=False)
                     for _ in range(R)]).astype(np.int32)
    cand_ok = rs.random((R, C)) < 0.8
    key = (rs.integers(0, 4, (R, C)) * 2 ** 20
           + rs.permutation(N)[cand]).astype(np.int32)
    have = rs.random((N, P)) < 0.1
    full = rs.random(N) < 0.02
    want = ref.match_requests_np(orders, n_walk, budgets, cand, cand_ok,
                                 key, have, full)
    got = sk.match_requests(T(orders), T(n_walk), T(budgets), T(cand),
                            T(cand_ok), T(key), T(have.astype(np.uint8)),
                            T(full.astype(np.uint8)))
    assert np.array_equal(got.numpy(), want)
    assert (want >= 0).sum() > 50


@pytest.mark.parametrize("seed", SEEDS)
def test_holder_topk_matches_numpy(seed):
    rng = random.Random(600 + seed)
    for _ in range(25):
        n = rng.randrange(1, 14)
        p = rng.randrange(1, 20)
        k = rng.randrange(1, 16)
        keys = np.full((n, p), ref.KEY_INF32, dtype=np.int32)
        for col in range(p):
            rows = rng.sample(range(n), rng.randrange(0, n + 1))
            for r, v in zip(rows, rng.sample(range(1 << 27), len(rows))):
                keys[r, col] = v
        got = sk.holder_topk(T(keys), k)
        want = ref.holder_topk_np(keys, k)
        assert got.shape == (k, p)
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(got.numpy(), _holder_topk_scalar(keys, k))


def test_rarest_order_single_matches_numpy():
    rng = random.Random(9)
    for _ in range(30):
        n = rng.randrange(1, 50)
        counts = np.array([rng.randrange(0, 9) for _ in range(n)],
                          dtype=np.int32)
        missing = rng.sample(range(n), rng.randrange(0, n + 1))
        off = rng.randrange(0, 3000)
        assert sk.rarest_order_single(missing, T(counts), off, n) == \
            ref.rarest_order_single(missing, counts, off, n,
                                    backend="numpy")


def test_constants_match_reference():
    assert int(sk.KEY_INF) == int(ref.KEY_INF)
    assert int(sk.KEY_INF32) == int(ref.KEY_INF32)
    assert int(sk.COST_NONE) == int(ref.COST_NONE)


# ================= Pallas kernels, interpret mode ======================= #
def _need_pallas():
    if "pallas" not in ref.available_backends():
        pytest.skip("jax with Pallas is not installed")


@pytest.mark.parametrize("seed", [0, 1])
def test_rarest_orders_match_pallas_interpret(seed):
    _need_pallas()
    rng = random.Random(700 + seed)
    for _ in range(3):
        n, counts, missing, offsets = _rarest_case(rng, max_pieces=80,
                                                   max_rows=10)
        want = ref.rarest_orders(missing, counts, offsets, n,
                                 backend="pallas")
        got = sk.rarest_orders(T(missing), T(counts), T(offsets), n)
        assert np.array_equal(got.numpy(), want)
        keys = ref.rarest_keys(counts, offsets, n, backend="pallas")
        assert np.array_equal(sk.rarest_keys(T(counts), T(offsets), n)
                              .numpy(), keys)


@pytest.mark.parametrize("seed", [0, 1])
def test_island_has_matches_pallas_interpret(seed):
    _need_pallas()
    rng = random.Random(800 + seed)
    for _ in range(3):
        have, member, _ = _island_case(rng)
        want = ref.island_has(have, member, backend="pallas")
        assert np.array_equal(sk.island_has(T(have), T(member)).numpy(),
                              want)


@pytest.mark.parametrize("case", sorted(set(COST_ROWS_CASES) - {"no_rows"}))
def test_island_cost_rows_matches_pallas_interpret(case):
    """The cost rows against the reference composition with its Pallas
    `island_has` (interpret mode); N=0 is left to the numpy case above."""
    _need_pallas()
    args = _cost_rows_case(case, 1100)
    have, full, alive, island, n, rows, cost = args
    got = sk.island_cost_rows(T(have.astype(np.uint8)),
                              T(full.astype(np.uint8)),
                              T(alive.astype(np.uint8)), T(island), n,
                              T(rows), T(cost))
    assert np.array_equal(got.numpy(),
                          _cost_rows_reference(*args, backend="pallas"))


@pytest.mark.parametrize("seed", [0, 1])
def test_match_requests_matches_pallas_interpret(seed):
    _need_pallas()
    rng = random.Random(900 + seed)
    for _ in range(3):
        case = _random_match_case(rng)
        want = ref.match_requests(*case, backend="pallas")
        assert np.array_equal(sk.match_requests(*map(T, case)).numpy(),
                              want)
