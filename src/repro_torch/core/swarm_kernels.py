"""Batched swarm decision kernels on tensors: rarest-first scoring, P4P
island availability, choke ranking, fused request matching and the
endgame holder shortlist, for ALL nodes of a swarm in one pass.

Counterpart of `repro.core.swarm_kernels`, with the same decisions bit for
bit (that module's numpy backend is the reference).  There is no backend
switch: the device of the tensors decides the path.

  * a CUDA tensor launches the hand-written Hopper kernel
    (`csrc/swarm_kernels.cu`, built by `repro_torch.kernels_build`), or
    raises — nothing falls back to the plain version;
  * a CPU tensor takes the plain PyTorch version beside each kernel
    (`rarest_keys_plain`, `rarest_orders_plain`, `island_has_plain`,
    `island_cost_rows_plain`, `match_requests_plain`,
    `match_requests_ragged_plain`);
  * any other device raises.

The kernels: `rarest_keys` (the keys alone), `rarest_orders` /
`cost_orders` (keys and their stable order in one launch), `island_has`,
`island_cost_rows` (the hub's P4P cost rows from its device planes in
one launch), and `match_requests` / `match_requests_ragged` (dense or CSR
candidate rows, one launch for all of them).  `choke_order`,
`min_island_cost` and `holder_topk` are plain torch ops on whatever
device their inputs live on.  Each kernel wrapper adds one to
`LAUNCHES[name]` where it launches, and nowhere else; ``name.route``
counts the launches of each route that the shapes choose (see
`_orders_route`, `_match_route`).

Keys are int64 throughout (the reference numpy backend's width), so the
int32 ceiling of the Pallas scoring kernel (counts * P^2 < 2^31) does not
apply; the fused matcher's holder keys stay int32 (cost * 2^20 + rank).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels.common import check as _check
from repro_torch.kernels.common import lib as _lib
from repro_torch.kernels.common import on_card  # noqa: F401
from repro_torch.kernels.common import require as _require
from repro_torch.kernels.common import stream as _stream

# sentinel key for pieces a row must not request: above any real key
KEY_INF = np.int64(2 ** 62)
# sentinel for the int32 holder keys of the matcher / endgame shortlist
KEY_INF32 = np.int32(2 ** 30)
# "no holder anywhere" ALTO cost: above any real cost (<= 15)
COST_NONE = np.int64(64)

LAUNCHES: Dict[str, int] = {
    "rarest_keys": 0, "rarest_keys.warp": 0, "rarest_keys.sort": 0,
    "island_has": 0, "island_cost_rows": 0, "match_requests": 0,
    "match_requests.reg": 0, "match_requests.wide": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A 0/1 byte view of a bool or uint8 tensor (no copy for either)."""
    if t.dtype == torch.bool:
        return t.contiguous().view(torch.uint8)
    return t.to(torch.uint8).contiguous()


# ====================== rarest-first scoring ============================ #
# `rarest_first_order_np` sorts missing pieces by (availability, rotated
# id, raw id); with counts < COUNT_CAP and ids < n the three keys pack
# losslessly into one int64: key = (counts * n + rot) * n + p.

def rarest_keys_plain(counts: torch.Tensor, offsets: torch.Tensor,
                      n_pieces: int, missing: Optional[torch.Tensor] = None,
                      piece_cost: Optional[torch.Tensor] = None,
                      span: int = 0) -> torch.Tensor:
    """(R, P) int64 composite keys, optionally plus ``piece_cost * span``
    and with KEY_INF where ``missing`` is False."""
    n = max(int(n_pieces), 1)
    dev = counts.device
    p = torch.arange(n, dtype=torch.int64, device=dev)
    rot = torch.remainder(p[None, :] + offsets.to(torch.int64)[:, None], n)
    keys = (counts.to(torch.int64)[None, :] * n + rot) * n + p[None, :]
    if piece_cost is not None:
        keys = piece_cost.to(torch.int64) * int(span) + keys
    if missing is not None:
        keys = torch.where(missing.to(torch.bool), keys,
                           torch.full_like(keys, int(KEY_INF)))
    return keys


def _launch_rarest_keys(counts: torch.Tensor, offsets: torch.Tensor,
                        n: int, missing: Optional[torch.Tensor],
                        piece_cost: Optional[torch.Tensor],
                        span: int) -> torch.Tensor:
    rows = offsets.shape[0]
    _require(counts, "counts", torch.int64, (n,))
    _require(offsets, "offsets", torch.int64, (rows,))
    if missing is not None:
        _require(missing, "missing", torch.uint8, (rows, n))
    if piece_cost is not None:
        _require(piece_cost, "piece_cost", torch.int64, (rows, n))
    out = torch.empty((rows, n), dtype=torch.int64, device=counts.device)
    lib = _lib()
    rc = lib.rarest_keys_launch(
        counts.data_ptr(), offsets.data_ptr(),
        missing.data_ptr() if missing is not None else None,
        piece_cost.data_ptr() if piece_cost is not None else None,
        int(span), rows, n, out.data_ptr(), _stream(counts.device))
    _check(rc, "rarest_keys")
    if rows > 0:
        LAUNCHES["rarest_keys"] += 1
    return out


def rarest_keys(counts: torch.Tensor, offsets: torch.Tensor, n_pieces: int,
                missing: Optional[torch.Tensor] = None,
                piece_cost: Optional[torch.Tensor] = None,
                span: int = 0) -> torch.Tensor:
    """Composite rarest-first keys for many nodes at once.

    ``counts`` (P,) availability counts; ``offsets`` (R,) per-node
    tie-break rotations; optional ``missing`` (R, P) mask (KEY_INF where
    False) and ``piece_cost`` (R, P) cost term scaled by ``span``.
    ``argsort(keys[r])`` is ``rarest_first_order_np(range(P), counts,
    offsets[r], P)``.
    """
    if not on_card(counts, offsets, missing, piece_cost):
        return rarest_keys_plain(counts, offsets, n_pieces, missing,
                                 piece_cost, span)
    n = max(int(n_pieces), 1)
    return _launch_rarest_keys(
        counts.to(torch.int64).contiguous(),
        offsets.to(torch.int64).contiguous(), n,
        None if missing is None else _bytes(missing),
        None if piece_cost is None
        else piece_cost.to(torch.int64).contiguous(), span)


def _argsort_rows(keys: torch.Tensor) -> torch.Tensor:
    # stable: masked entries all carry KEY_INF and keep index order
    return torch.sort(keys, dim=1, stable=True).indices.to(torch.int32)


def rarest_orders_plain(counts: torch.Tensor, offsets: torch.Tensor,
                        n_pieces: int, missing: Optional[torch.Tensor] = None,
                        piece_cost: Optional[torch.Tensor] = None,
                        span: int = 0) -> torch.Tensor:
    """(R, P) int32: each row's piece ids in the stable ascending order of
    its `rarest_keys_plain` keys."""
    return _argsort_rows(rarest_keys_plain(counts, offsets, n_pieces,
                                           missing, piece_cost, span))


# the fused order kernel takes one warp a row, up to 64 pieces; wider rows
# take the keys kernel, then torch.sort
_ORDERS_WARP_MAX = 64


def _orders_route(n: int) -> str:
    return "warp" if n <= _ORDERS_WARP_MAX else "sort"


def _launch_rarest_orders(counts: torch.Tensor, offsets: torch.Tensor,
                          n: int, missing: Optional[torch.Tensor],
                          piece_cost: Optional[torch.Tensor],
                          span: int) -> torch.Tensor:
    route = _orders_route(n)
    if route == "sort":
        out = _argsort_rows(_launch_rarest_keys(counts, offsets, n, missing,
                                                piece_cost, span))
        if out.shape[0] > 0:
            LAUNCHES["rarest_keys.sort"] += 1
        return out
    rows = offsets.shape[0]
    _require(counts, "counts", torch.int64, (n,))
    _require(offsets, "offsets", torch.int64, (rows,))
    if missing is not None:
        _require(missing, "missing", torch.uint8, (rows, n))
    if piece_cost is not None:
        _require(piece_cost, "piece_cost", torch.int64, (rows, n))
    out = torch.empty((rows, n), dtype=torch.int32, device=counts.device)
    rc = _lib().rarest_orders_launch(
        counts.data_ptr(), offsets.data_ptr(),
        missing.data_ptr() if missing is not None else None,
        piece_cost.data_ptr() if piece_cost is not None else None,
        int(span), rows, n, out.data_ptr(), _stream(counts.device))
    _check(rc, "rarest_orders")
    if rows > 0:
        LAUNCHES["rarest_keys"] += 1
        LAUNCHES["rarest_keys.warp"] += 1
    return out


def _orders(counts: torch.Tensor, offsets: torch.Tensor, n_pieces: int,
            missing: Optional[torch.Tensor],
            piece_cost: Optional[torch.Tensor], span: int) -> torch.Tensor:
    if not on_card(counts, offsets, missing, piece_cost):
        return rarest_orders_plain(counts, offsets, n_pieces, missing,
                                   piece_cost, span)
    return _launch_rarest_orders(
        counts.to(torch.int64).contiguous(),
        offsets.to(torch.int64).contiguous(), max(int(n_pieces), 1),
        None if missing is None else _bytes(missing),
        None if piece_cost is None
        else piece_cost.to(torch.int64).contiguous(), span)


def rarest_orders(missing: torch.Tensor, counts: torch.Tensor,
                  offsets: torch.Tensor, n_pieces: int) -> torch.Tensor:
    """Batched `rarest_first_order_np`: (R, P) int32 piece order per node;
    row r's first ``missing[r].sum()`` entries are its missing pieces in
    rarest-first order.  On the card, keys and order are one launch."""
    return _orders(counts, offsets, n_pieces, missing, None, 0)


# ================== topology-aware (P4P) scoring ======================== #
def island_has_plain(have: torch.Tensor,
                     member: torch.Tensor) -> torch.Tensor:
    """(K, P) bool: does any node of island k (``member`` (K, N)) hold
    piece p (``have`` (N, P), dead rows already zeroed)?"""
    m = member.to(torch.int64)
    h = have.to(torch.int64)
    if m.shape[1] == 0:
        return torch.zeros((m.shape[0], h.shape[1]), dtype=torch.bool,
                           device=have.device)
    return (m[:, :, None] * h[None, :, :]).amax(dim=1) > 0


def _launch_island_has(have: torch.Tensor,
                       member: torch.Tensor) -> torch.Tensor:
    n, p = have.shape
    k = member.shape[0]
    _require(have, "have", torch.uint8, (n, p))
    _require(member, "member", torch.uint8, (k, n))
    out = torch.empty((k, p), dtype=torch.uint8, device=have.device)
    rc = _lib().island_has_launch(have.data_ptr(), member.data_ptr(), n, k,
                                  p, out.data_ptr(), _stream(have.device))
    _check(rc, "island_has")
    if k > 0 and p > 0:
        LAUNCHES["island_has"] += 1
    return out.view(torch.bool)


def island_has(have: torch.Tensor, member: torch.Tensor) -> torch.Tensor:
    """Island-level availability reduction (see `island_has_plain`)."""
    if not on_card(have, member):
        return island_has_plain(have, member)
    return _launch_island_has(_bytes(have), _bytes(member))


def min_island_cost(avail: torch.Tensor, cost: torch.Tensor) -> torch.Tensor:
    """(K, P) int64 cheapest-holder cost per source island: entry [s, p] is
    min cost[s, k] over islands k holding p, COST_NONE where none does."""
    a = avail.to(torch.bool)
    c = cost.to(torch.int64)
    plane = torch.where(a[None, :, :], c[:, :, None],
                        torch.full((), int(COST_NONE), dtype=torch.int64,
                                   device=c.device))
    return plane.amin(dim=1)


def island_cost_rows_plain(have: torch.Tensor, full: torch.Tensor,
                           alive: torch.Tensor, island: torch.Tensor, n: int,
                           rows: torch.Tensor,
                           cost: torch.Tensor) -> torch.Tensor:
    """(len(rows), P) int64 cheapest-holder cost rows of the hub's P4P
    pump: the alive have plane ``(have | full) & alive`` of rows [0, n)
    reduced to island availability (`island_has_plain`), the per-source
    island cost plane (`min_island_cost`), and each row's island's row of
    it.  ``have`` (cap, P) and ``full``, ``alive``, ``island`` (cap,) are
    the hub's planes; ``rows`` index them; ``cost`` is (K, K)."""
    n = int(n)
    k = cost.shape[0]
    dev = have.device
    u8 = torch.uint8
    plane = (have[:n].to(u8) | full[:n, None].to(u8)) \
        & alive[:n, None].to(u8)
    isl = island.to(torch.int64)
    member = torch.zeros((k, n), dtype=torch.uint8, device=dev)
    member[isl[:n], torch.arange(n, device=dev)] = 1
    avail = island_has_plain(plane, member)
    return min_island_cost(avail, cost)[isl[rows.to(torch.int64)]]


# what the kernel's shared memory holds (csrc/swarm_kernels.cu)
_COST_MAX_ISLANDS = 64
_COST_MAX_PIECES = 4096


def _launch_island_cost_rows(have: torch.Tensor, full: torch.Tensor,
                             alive: torch.Tensor, island: torch.Tensor,
                             n: int, rows: torch.Tensor,
                             cost: torch.Tensor) -> torch.Tensor:
    cap, p = have.shape
    k = cost.shape[0]
    r = rows.shape[0]
    _require(have, "have", torch.uint8, (cap, p))
    _require(full, "full", torch.uint8, (cap,))
    _require(alive, "alive", torch.uint8, (cap,))
    _require(island, "island", torch.int64, (cap,))
    _require(rows, "rows", torch.int64, (r,))
    _require(cost, "cost", torch.int64, (k, k))
    if not 1 <= k <= _COST_MAX_ISLANDS or not 1 <= p <= _COST_MAX_PIECES:
        raise ValueError(f"island_cost_rows kernel takes 1 <= K <= "
                         f"{_COST_MAX_ISLANDS} islands and 1 <= P <= "
                         f"{_COST_MAX_PIECES} pieces; got K={k} P={p}")
    if not 0 <= n <= cap:
        raise ValueError(f"n={n} rows outside the planes' {cap}")
    out = torch.empty((r, p), dtype=torch.int64, device=have.device)
    rc = _lib().island_cost_rows_launch(
        have.data_ptr(), full.data_ptr(), alive.data_ptr(),
        island.data_ptr(), rows.data_ptr(), cost.data_ptr(), cap, n, p, k, r,
        out.data_ptr(), _stream(have.device))
    _check(rc, "island_cost_rows")
    if r > 0:
        LAUNCHES["island_cost_rows"] += 1
    return out


def island_cost_rows(have: torch.Tensor, full: torch.Tensor,
                     alive: torch.Tensor, island: torch.Tensor, n: int,
                     rows: torch.Tensor, cost: torch.Tensor) -> torch.Tensor:
    """The P4P cost rows of `island_cost_rows_plain`; on the card one
    launch reads the planes in place.  ``rows`` must lie in [0, cap) and
    the islands in [0, K): the plain version raises otherwise, the kernel
    gives such rows COST_NONE."""
    if not on_card(have, full, alive, island, rows, cost):
        return island_cost_rows_plain(have, full, alive, island, n, rows,
                                      cost)
    return _launch_island_cost_rows(
        _bytes(have), _bytes(full), _bytes(alive),
        island.to(torch.int64).contiguous(), int(n),
        rows.to(torch.int64).contiguous(), cost.to(torch.int64).contiguous())


def _cost_span(counts: torch.Tensor, n_pieces: int,
               max_count: Optional[int]) -> int:
    """``(max_count + 1) * n^2``: the cost term's scale, above any rarest
    key; ``max_count`` from a host copy of the counts avoids a sync."""
    n = max(int(n_pieces), 1)
    if max_count is None:
        max_count = int(counts.max().item()) if counts.numel() else 0
    return (int(max_count) + 1) * n * n


def cost_rarest_keys(counts: torch.Tensor, offsets: torch.Tensor,
                     piece_cost: torch.Tensor, n_pieces: int,
                     missing: Optional[torch.Tensor] = None,
                     max_count: Optional[int] = None) -> torch.Tensor:
    """Cost-primary keys ``piece_cost * span + rarest_key`` with
    ``span = (max_count + 1) * n^2``.  Pass ``max_count`` from a host copy
    of the counts to avoid a device sync."""
    return rarest_keys(counts, offsets, n_pieces, missing=missing,
                       piece_cost=piece_cost,
                       span=_cost_span(counts, n_pieces, max_count))


def cost_orders(missing: torch.Tensor, counts: torch.Tensor,
                offsets: torch.Tensor, piece_cost: torch.Tensor,
                n_pieces: int, max_count: Optional[int] = None) \
        -> torch.Tensor:
    """Batched cost-aware piece order: (cheapest-holder cost, rarity,
    rotated id, id) per node; same contract as `rarest_orders`."""
    return _orders(counts, offsets, n_pieces, missing, piece_cost,
                   _cost_span(counts, n_pieces, max_count))


# ========================= choke ranking ================================ #
def choke_order(recv: torch.Tensor, sent: torch.Tensor, cand: torch.Tensor,
                ranks: torch.Tensor) -> torch.Tensor:
    """Rank every holder's unchoke candidates by (-recv, -sent, rank) via
    a chain of stable sorts; non-candidates sort last.  ``ranks`` is (C,)
    or (H, C).  Returns (H, C) int32 column indices."""
    cand = cand.to(torch.bool)
    neg = torch.full((), -1.0, dtype=torch.float32, device=recv.device)
    r1 = torch.where(cand, recv.to(torch.float32), neg)
    r2 = torch.where(cand, sent.to(torch.float32), neg)
    rk = ranks.to(torch.int64)
    if rk.dim() == 1:
        rk = rk[None, :]
    top = rk.max() + 1 if rk.numel() else torch.ones((), dtype=torch.int64)
    nm = torch.where(cand, rk, top.to(rk.device))
    order = torch.sort(nm, dim=1, stable=True).indices
    for key in (-r2, -r1):
        # + 0.0 turns -0.0 into +0.0 so zero rates tie on every sort
        k = torch.gather(key + 0.0, 1, order)
        order = torch.gather(order, 1,
                             torch.sort(k, dim=1, stable=True).indices)
    return order.to(torch.int32)


# ==================== fused request matching ============================ #
# One greedy walk per row over its piece order: at step k, the untaken
# usable candidate with the lowest (cand_key, c) holding piece orders[r, k]
# is picked, marked taken and charged one budget unit.  Holder keys are
# int32 ``cost * 2^20 + rank`` and must stay below KEY_INF32.

def match_requests_plain(orders: torch.Tensor, n_walk: torch.Tensor,
                         budgets: torch.Tensor, cand: torch.Tensor,
                         cand_ok: torch.Tensor, cand_key: torch.Tensor,
                         have: torch.Tensor, full: torch.Tensor) \
        -> torch.Tensor:
    """(R, P) int32 picks: ``picks[r, k]`` is the holder row chosen for
    piece ``orders[r, k]``, or -1.  A row stops when its budget is spent,
    its walk ends, or all its candidates are taken."""
    dev = orders.device
    R, P = orders.shape
    picks = torch.full((R, P), -1, dtype=torch.int32, device=dev)
    C = cand.shape[1] if cand.dim() == 2 else 0
    if R == 0 or C == 0:
        return picks
    cand = cand.to(torch.int64)
    safe = torch.where(cand >= 0, cand, torch.zeros_like(cand))
    have_b = have.to(torch.bool)
    full_b = full.to(torch.bool)
    taken = ~cand_ok.to(torch.bool)
    budget = budgets.to(torch.int64).clone()
    walk = n_walk.to(torch.int64)
    key = cand_key.to(torch.int64)
    inf = torch.full_like(key, int(KEY_INF32))
    ridx = torch.arange(R, device=dev)
    kmax = int(min(max(int(walk.max().item()), 0), P))
    for k in range(kmax):
        act = (budget > 0) & (k < walk) & ~taken.all(dim=1)
        if not bool(act.any()):
            break
        p = orders[:, k].to(torch.int64)
        col = have_b[safe, p[:, None]] | full_b[safe]          # (R, C)
        okk = ~taken & col & act[:, None]
        sel = okk.any(dim=1)
        c = torch.argmin(torch.where(okk, key, inf), dim=1)
        picks[sel, k] = cand[sel, c[sel]].to(torch.int32)
        taken[ridx[sel], c[sel]] = True
        budget -= sel.to(torch.int64)
    return picks


def match_requests_ragged_plain(orders: torch.Tensor, row_of: torch.Tensor,
                                cand_ptr: torch.Tensor, cand: torch.Tensor,
                                cand_ok: torch.Tensor, cand_key: torch.Tensor,
                                n_walk: torch.Tensor, budgets: torch.Tensor,
                                have: torch.Tensor, full: torch.Tensor) \
        -> torch.Tensor:
    """`match_requests_ragged` by padding the CSR rows into the dense form
    (``cand = -1``, not usable, past each row's degree)."""
    dev = orders.device
    R = row_of.shape[0]
    ptr = cand_ptr.to(torch.int64)
    deg = ptr[1:] - ptr[:-1]
    C = int(deg.max().item()) if R else 0
    flat = torch.arange(int(ptr[0]), int(ptr[-1]), device=dev)
    rowid = torch.repeat_interleave(torch.arange(R, device=dev), deg)
    col = flat - ptr[rowid]
    dcand = torch.full((R, C), -1, dtype=torch.int32, device=dev)
    dok = torch.zeros((R, C), dtype=torch.bool, device=dev)
    dkey = torch.full((R, C), int(KEY_INF32), dtype=torch.int32, device=dev)
    dcand[rowid, col] = cand[flat].to(torch.int32)
    dok[rowid, col] = cand_ok[flat].to(torch.bool)
    dkey[rowid, col] = cand_key[flat].to(torch.int32)
    return match_requests_plain(orders[row_of.to(torch.int64)], n_walk,
                                budgets, dcand, dok, dkey, have, full)


# the register route keeps a row's sorted candidates in registers, up to
# 16 slots a lane (degree 512) with a 64-bit have mask each (P <= 64);
# other rows take the wide route, whose scratch holds each candidate
# slot's packed word and ceil(P / 64) mask words
_REG_MAX_DEGREE = 512
_REG_MAX_PIECES = 64


def _match_route(n_pieces: int, max_degree: int) -> str:
    return ("reg" if n_pieces <= _REG_MAX_PIECES
            and max_degree <= _REG_MAX_DEGREE else "wide")


def _launch_match(orders, row_of, cand_ptr, stride, n_walk, budgets, cand,
                  cand_ok, cand_key, have, full, max_degree) -> torch.Tensor:
    """One launch over every row: dense (``cand_ptr`` None, ``stride``
    candidates a row) or CSR; ``row_of`` None walks ``orders[r]``.
    ``max_degree`` must be the largest row degree: it picks the route and
    sizes the wide route's scratch."""
    P = orders.shape[1]
    R = n_walk.shape[0]
    N = have.shape[0]
    _require(orders, "orders", torch.int32, (orders.shape[0], P))
    if row_of is not None:
        _require(row_of, "row_of", torch.int32, (R,))
    if cand_ptr is not None:
        _require(cand_ptr, "cand_ptr", torch.int32, (R + 1,))
    _require(n_walk, "n_walk", torch.int32, (R,))
    _require(budgets, "budgets", torch.int32, (R,))
    _require(cand, "cand", torch.int32, tuple(cand.shape))
    _require(cand_ok, "cand_ok", torch.uint8, tuple(cand.shape))
    _require(cand_key, "cand_key", torch.int32, tuple(cand.shape))
    _require(have, "have", torch.uint8, (N, P))
    _require(full, "full", torch.uint8, (N,))
    dev = orders.device
    picks = torch.empty((R, P), dtype=torch.int32, device=dev)
    route = _match_route(P, max_degree)
    scratch = (torch.empty(cand.numel() * (1 + (P + 63) // 64),
                           dtype=torch.int64, device=dev)
               if route == "wide" else None)
    rc = _lib().match_requests_launch(
        orders.data_ptr(), row_of.data_ptr() if row_of is not None else None,
        cand_ptr.data_ptr() if cand_ptr is not None else None, int(stride),
        n_walk.data_ptr(), budgets.data_ptr(), cand.data_ptr(),
        cand_ok.data_ptr(), cand_key.data_ptr(), have.data_ptr(),
        full.data_ptr(), R, P, int(max_degree), cand.numel(),
        scratch.data_ptr() if scratch is not None else None,
        picks.data_ptr(), _stream(dev))
    _check(rc, "match_requests")
    if R > 0:
        LAUNCHES["match_requests"] += 1
        LAUNCHES[f"match_requests.{route}"] += 1
    return picks


def _launch_match_requests(orders, n_walk, budgets, cand, cand_ok, cand_key,
                           have, full) -> torch.Tensor:
    R, C = cand.shape
    _require(orders, "orders", torch.int32, (R, orders.shape[1]))
    return _launch_match(orders, None, None, C, n_walk, budgets, cand,
                         cand_ok, cand_key, have, full, C)


def _launch_match_requests_ragged(orders, row_of, cand_ptr, cand, cand_ok,
                                  cand_key, n_walk, budgets, have, full,
                                  max_degree) -> torch.Tensor:
    _require(cand, "cand", torch.int32, (cand.shape[0],))
    return _launch_match(orders, row_of, cand_ptr, 0, n_walk, budgets, cand,
                         cand_ok, cand_key, have, full, max_degree)


def match_requests(orders: torch.Tensor, n_walk: torch.Tensor,
                   budgets: torch.Tensor, cand: torch.Tensor,
                   cand_ok: torch.Tensor, cand_key: torch.Tensor,
                   have: torch.Tensor, full: torch.Tensor) -> torch.Tensor:
    """Greedy holder-match for many rows at once (see
    `match_requests_plain`).  ``have`` (N, P) and ``full`` (N,) are read
    in place: on the card they are the hub's device planes."""
    if not on_card(orders, n_walk, budgets, cand, cand_ok, cand_key, have,
                   full):
        return match_requests_plain(orders, n_walk, budgets, cand, cand_ok,
                                    cand_key, have, full)
    R, P = orders.shape
    if R == 0 or P == 0 or cand.dim() != 2 or cand.shape[1] == 0:
        return torch.full((R, P), -1, dtype=torch.int32,
                          device=orders.device)
    i32 = torch.int32
    return _launch_match_requests(
        orders.to(i32).contiguous(), n_walk.to(i32).contiguous(),
        budgets.to(i32).contiguous(), cand.to(i32).contiguous(),
        _bytes(cand_ok), cand_key.to(i32).contiguous(), _bytes(have),
        _bytes(full))


def match_requests_ragged(orders: torch.Tensor, row_of: torch.Tensor,
                          cand_ptr: torch.Tensor, cand: torch.Tensor,
                          cand_ok: torch.Tensor, cand_key: torch.Tensor,
                          n_walk: torch.Tensor, budgets: torch.Tensor,
                          have: torch.Tensor, full: torch.Tensor,
                          cand_ptr_host: Optional[np.ndarray] = None) \
        -> torch.Tensor:
    """`match_requests` over ragged rows in one launch: row r walks
    ``orders[row_of[r]]`` (the pump's order rows, read in place) over the
    candidates ``cand[cand_ptr[r]:cand_ptr[r + 1]]`` with ``cand_ok`` and
    ``cand_key`` beside them; ``n_walk``, ``budgets`` (R,).  Returns (R, P)
    int32 picks.  ``cand_ptr_host``, a host copy of ``cand_ptr``, gives
    the largest degree (which picks the route) without a device sync;
    without it, ``cand_ptr`` is read back."""
    if not on_card(orders, row_of, cand_ptr, cand, cand_ok, cand_key, n_walk,
                   budgets, have, full):
        return match_requests_ragged_plain(orders, row_of, cand_ptr, cand,
                                           cand_ok, cand_key, n_walk, budgets,
                                           have, full)
    R, P = row_of.shape[0], orders.shape[1]
    if R == 0 or P == 0:
        return torch.full((R, P), -1, dtype=torch.int32,
                          device=orders.device)
    if cand_ptr_host is None:
        max_degree = int((cand_ptr[1:] - cand_ptr[:-1]).max().item())
    else:
        host = np.asarray(cand_ptr_host)
        if host.shape != (R + 1,):
            raise ValueError(f"cand_ptr_host has shape {host.shape}, "
                             f"expected ({R + 1},)")
        max_degree = int(np.diff(host).max())
    i32 = torch.int32
    return _launch_match_requests_ragged(
        orders.to(i32).contiguous(), row_of.to(i32).contiguous(),
        cand_ptr.to(i32).contiguous(), cand.to(i32).contiguous(),
        _bytes(cand_ok), cand_key.to(i32).contiguous(),
        n_walk.to(i32).contiguous(), budgets.to(i32).contiguous(),
        _bytes(have), _bytes(full), int(max_degree))


# ===================== endgame holder top-k ============================= #
def holder_topk(keys: torch.Tensor, k: int) -> torch.Tensor:
    """(K, P) int32 row indices of the K smallest keys per column,
    ascending; entries whose key is KEY_INF32 are -1, and columns with
    fewer than K rows are -1 padded.  Keys are unique per column among
    valid holders (they embed the name rank), so the result is exact."""
    n, p = keys.shape
    kk = min(int(k), n)
    dev = keys.device
    if kk <= 0 or p == 0:
        return torch.full((max(int(k), 0), p), -1, dtype=torch.int32,
                          device=dev)
    vals, idx = torch.topk(keys.to(torch.int64).T, kk, dim=1,
                           largest=False, sorted=True)
    out = torch.where(vals < int(KEY_INF32), idx,
                      torch.full_like(idx, -1)).to(torch.int32).T
    if kk < int(k):
        pad = torch.full((int(k) - kk, p), -1, dtype=torch.int32,
                         device=dev)
        out = torch.cat([out, pad], dim=0)
    return out.contiguous()


# ===================== scalar-compatible wrapper ======================== #
def rarest_order_single(missing: Sequence[int], counts: torch.Tensor,
                        offset: int, n_pieces: int) -> List[int]:
    """One node's rarest-first order over `missing`, with
    `rarest_first_order_np`'s semantics (the differential tests' bridge)."""
    idx = list(missing)
    if not idx:
        return []
    dev = counts.device
    m = torch.zeros((1, n_pieces), dtype=torch.bool, device=dev)
    m[0, torch.as_tensor(idx, dtype=torch.int64, device=dev)] = True
    off = torch.as_tensor([int(offset)], dtype=torch.int64, device=dev)
    order = rarest_orders(m, counts, off, n_pieces)
    return order[0, : len(idx)].tolist()
