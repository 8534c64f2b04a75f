#!/usr/bin/env python3
"""Smoke run of `repro_torch` on one CUDA card (an H100).

    python3 chip_smoke.py

1. builds the port's CUDA kernels (`src/repro_torch/csrc/`) with nvcc
   into `build/repro_torch/`, one nvcc per source, all started together;
2. swarm slice: holds each swarm kernel against its plain PyTorch
   version on CUDA tensors at the main path's shapes, exactly, and times
   it: the fused `rarest_orders` / `cost_orders` (keys and their stable
   order in one launch) against the plain keys and a stable argsort,
   beside the keys kernel with `torch.sort` that it replaced; the sort
   route that 128 pieces take (keys kernel + `torch.sort`, R=200) beside
   `torch.sort` alone; `island_has` (v1, the reduction alone) and
   `island_cost_rows` (v2: the hub's whole P4P cost plane, from its
   device planes to the per-row cost rows, in one launch) at N = R = 500
   and 2000 and with dead rows, full rows and an empty island, timed in
   turns against the v1 composition (plane ops, `island_has`,
   `min_island_cost`, gathers); the dense `match_requests` (P=64,
   C = 8..512; P=128, C = 8/64/200 on the wide route) and
   `match_requests_ragged` on pump-shaped CSR rows (degrees 1-64, and
   1-600 with the wide route); then drives on the card, each against
   `src/repro_torch/reference_runs.json` (the reference package's
   virtual-time values under PYTHONHASHSEED=0):
   - Scenario VII at N=2000 and Scenario IX at N=500 with 8 islands
     (both arms): the batched flash crowd;
   - Scenario VIII at N=200 batched (fault-free and chaos arms: loss,
     duplication, jitter, 30% churn with restarts, a partition), each
     arm's invariants checked on the card, device planes included;
   - one `ChaosScenario` at N=200 on 8 ISP islands with an island cut
     off (the P4P arm under faults), its invariants checked;
   - Scenario X at N=200 (128 pieces: v1 crowd, v2 delta, scratch
     re-fetch, and the scalar chaos overlay), which must upgrade every
     volunteer with no stale piece accepted;
   checks that every swarm kernel launched on this path, that each pump
   launched the piece orders once on its width's route (fused warp
   kernel to 64 pieces, keys + `torch.sort` and only the matcher's wide
   route above), the matcher at most once, and `island_cost_rows`
   exactly once for each pump that orders pieces under a topology (and
   the v1 `island_has` never), and prints each run's wall, tick and
   kernel seconds, its kernel calls and ms per call as issued, and its
   launches per route and per pump;
3. serve slice: holds `flash_fwd` and `ssd_scan` against their plain
   versions (the reference's kernel-test cases and the serve path's
   shapes: f32 on the CUDA-core kernels, bf16 on the tensor-core ones,
   and an f16 scan whose M passes f16's range, on the CUDA cores),
   times each at the serve shape against its CUDA-core kernel in turns
   (v1, v2, v2, v1) and flash beside `scaled_dot_product_attention`; runs
   zamba2-7b at full width cut to 7 layers in f32 against
   `src/repro_torch/reference_serve.json` (the reference package's
   prefill and decode logits); drives zamba2-7b at full depth and width in
   bf16 (B=4, S=2048 prefill, 32 decode steps) through `make_prefill_step`
   / `make_decode_step`, checks that each prefill launched `ssd_scan` 81
   and `flash_fwd` 13 times, all on the tensor-core route (by the
   wrappers' counts and by the kernel names in a profiler trace), and
   holds its logits to the plain torch
   paths; serves 4 requests through `ServingEngine` on the f32 model and
   holds each to a full-forward greedy decode;
4. train slice: zamba2-7b at full width cut to 13 layers (13 SSD layers,
   2 shared-attention hits; f32 masters, B=2, S=2048, remat "full"):
   one train step's loss and gradients through the kernels against the
   plain torch paths in f32 and in bf16 (`compare_routes`), with
   `ssd_scan` launched 26 and `flash_fwd` 4 times (forward and
   recompute; `.mma` in bf16) and no zero-gradient leaf; each layer's
   bf16 gradients on the same input through both routes
   (`block_grads_check`); three timed bf16 AdamW steps (tokens/s, peak
   memory) and a profile of one by class; the `Trainer` on a reduced zamba2 (d_model 512, S=2048, the
   kernels) resumed from its step-5 checkpoint, equal to the straight
   run; the 7-layer f32 zamba2 saved by `CheckpointStore`, fetched by
   two replicas through the scalar protocol, and cold-started on the
   card by `ServingEngine.from_swarm`, bit-equal leaves and
   `reference_serve.json`'s tokens;
5. prints the per-kernel JSON line (each row with its train-path
   launches), the card's name and power limit, and as the last line
   `{"ok": true, "device": {...}}`.

Any failure exits non-zero without the last line.  The protocol iterates
sets of node names, so the script re-executes itself under
PYTHONHASHSEED=0, the seed the expected values were taken under.
"""
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
RUNS_FILE = SRC / "repro_torch" / "reference_runs.json"
# the entries of reference_runs.json driven on the card, in order
CHIP_RUNS = ("vii_n2000", "ix_n500_i8", "viii_n200_batched",
             "chaos_n200_i8_batched", "x_n200")
SERVE_FILE = SRC / "repro_torch" / "reference_serve.json"
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
INT_OPS_PER_S = 67e12           # non-tensor-core rate (the fp32 table row)
F32_OPS_PER_S = 67e12           # fp32 outside the tensor cores
BF16_OPS_PER_S = 989e12         # bf16 / fp16 tensor cores, dense
# the kernel each row of the line reports (island_has: v2, the fused
# cost rows; its v1_ms is the composition around the v1 kernel)
KERNEL_OF_ROW = {"island_has": "island_cost_rows"}
SOURCES = {
    "rarest_keys": "src/repro_torch/csrc/swarm_kernels.cu",
    "island_has": "src/repro_torch/csrc/swarm_kernels.cu",
    "match_requests": "src/repro_torch/csrc/swarm_kernels.cu",
    "flash_fwd": "src/repro_torch/csrc/flash_fwd_mma.cu",
    "ssd_scan": "src/repro_torch/csrc/ssd_scan_mma.cu",
}
# the route each kernel of the line ran on its main path: bf16 serving
# takes the tensor-core kernels, the P4P cost rows one thread-block
# cluster
ROUTES = {"rarest_keys": "cuda", "island_has": "cuda-cluster",
          "match_requests": "cuda", "flash_fwd": "cuda-mma",
          "ssd_scan": "cuda-mma"}
REPLACES = {
    "rarest_keys": "src/repro/core/swarm_kernels.py:112",
    "island_has": "src/repro/core/swarm_kernels.py:221",
    "match_requests": "src/repro/core/swarm_kernels.py:487",
    "flash_fwd": "src/repro/kernels/flash_attention/kernel.py:90",
    "ssd_scan": "src/repro/kernels/ssd/kernel.py:80",
}
# the reference's kernel-test cases (tests/test_kernels.py)
FLASH_CASES = [
    # B, Sq, Skv, Hq, Hkv, D, causal, window
    (2, 128, 128, 4, 2, 32, True, 0),
    (1, 100, 100, 4, 4, 16, True, 0),
    (2, 128, 128, 8, 2, 32, True, 24),
    (2, 64, 128, 4, 2, 16, False, 0),
    (1, 256, 256, 2, 1, 64, True, 0),
]
SSD_CASES = [
    # B, S, H, P, G, N, chunk
    (2, 64, 4, 16, 1, 16, 16),
    (1, 96, 2, 32, 1, 8, 32),
    (2, 128, 4, 16, 2, 16, 64),
    (1, 50, 2, 16, 1, 16, 16),
]


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ============================ timing ==================================== #
def device_ms(fn, reps=25, inner=10):
    """Device time of one call: `inner` calls captured in a CUDA graph and
    replayed between two CUDA events, median over `reps` replays.  The
    graph takes the host's launch overhead out of the number."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def call_ms(fn, reps=25):
    """Time of one call as the host issues it (launch overhead and any
    host syncs included): CUDA events around each call, median."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ========================== kernel phase ================================ #
def kernel_phase(torch, sk):
    """Each kernel against its plain version on CUDA tensors, exactly, at
    the main path's shapes; returns one record per kernel (the first case
    of each is the one reported in the kernels line)."""
    import numpy as np
    dev = torch.device("cuda")
    rs = np.random.default_rng(2015)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    records = {}

    def check(name, case, got, want, n_bytes, n_ops, kernel, plain,
              library=None):
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            fail(f"{name} [{case}] disagrees with its plain version")
        err = float((got.to(torch.float64) - want.to(torch.float64))
                    .abs().max().item()) if got.numel() else 0.0
        ms = device_ms(kernel)
        ms_call = call_ms(kernel)
        plain_ms = call_ms(plain, reps=20)
        lib_ms = device_ms(library) if library is not None else None
        b_ms, b_by = bound(n_bytes, n_ops)
        rec = {"case": case, "max_abs_err": err, "ms": ms,
               "call_ms": ms_call, "plain_ms": plain_ms, "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": lib_ms, "bytes": n_bytes}
        records.setdefault(name, []).append(rec)
        log(f"[kernel] {name} {case}: exact, ms={ms:.5f} (one call as "
            f"issued {ms_call:.5f}) plain_ms={plain_ms:.5f} "
            f"bytes={n_bytes} bound_ms={b_ms:.6f} ({b_by})"
            + (f" library_ms={lib_ms:.5f}" if lib_ms is not None else ""))

    # ---- rarest_orders / cost_orders: keys and stable order, fused ------ #
    R, P = 2000, 64
    counts = up(rs.integers(0, 2001, P).astype(np.int64))
    offsets = up(rs.integers(0, 60_000, R).astype(np.int64))
    missing = up((rs.random((R, P)) < 0.6).astype(np.uint8))
    cost = up(rs.choice(np.array([0, 1, 7, 15, 64]), (R, P))
              .astype(np.int64))
    max_count = int(counts.max().item())
    span = (max_count + 1) * P * P
    for case, pc, sp in (("R=2000 P=64", None, 0),
                         ("R=2000 P=64 cost", cost, span)):
        def fused(pc=pc):
            if pc is None:
                return sk.rarest_orders(missing, counts, offsets, P)
            return sk.cost_orders(missing, counts, offsets, pc, P,
                                  max_count=max_count)

        def v1(pc=pc, sp=sp):
            return sk._argsort_rows(sk.rarest_keys(
                counts, offsets, P, missing=missing, piece_cost=pc, span=sp))

        keys = sk.rarest_keys_plain(counts, offsets, P, missing=missing,
                                    piece_cost=pc, span=sp)
        want = torch.sort(keys, dim=1, stable=True).indices.to(torch.int32)
        got = fused()
        if not torch.equal(v1(), want):
            fail(f"rarest keys + torch.sort [{case}] disagree")
        ins = [counts, offsets, missing] + ([pc] if pc is not None else [])
        # keys (~8 integer ops an entry) and a sort (log2 P compares)
        check("rarest_keys", case, got, want, nbytes(*ins, got),
              R * P * ((8 if pc is None else 10) + int(np.log2(P))),
              fused,
              lambda pc=pc, sp=sp: sk.rarest_orders_plain(
                  counts, offsets, P, missing=missing, piece_cost=pc,
                  span=sp),
              library=lambda k=keys: torch.sort(
                  k, dim=1, stable=True).indices.to(torch.int32))
        turns = [device_ms(f) for f in (v1, fused, fused, v1)]
        v1_keys = device_ms(lambda pc=pc, sp=sp: sk.rarest_keys(
            counts, offsets, P, missing=missing, piece_cost=pc, span=sp))
        rec = records["rarest_keys"][-1]
        rec.update(v1_ms=(turns[0] + turns[3]) / 2, v1_keys_ms=v1_keys)
        log(f"[kernel] rarest_keys {case}: turns (v1 keys + torch.sort, "
            f"fused, fused, v1) {' '.join(f'{t:.5f}' for t in turns)} ms; "
            f"v1 keys kernel alone {v1_keys:.5f} ms")

    # ---- the sort route above 64 pieces (Scenario X's 128) ------------- #
    # (drawn from a generator of their own, so that the other cases'
    # inputs stay those of earlier runs)
    rs128 = np.random.default_rng(2128)
    R128, P128 = 200, 128
    counts128 = up(rs128.integers(0, 201, P128).astype(np.int64))
    offsets128 = up(rs128.integers(0, 60_000, R128).astype(np.int64))
    missing128 = up((rs128.random((R128, P128)) < 0.6).astype(np.uint8))
    keys128 = sk.rarest_keys_plain(counts128, offsets128, P128,
                                   missing=missing128)
    want = torch.sort(keys128, dim=1, stable=True).indices.to(torch.int32)
    before = sk.LAUNCHES["rarest_keys.sort"]
    got = sk.rarest_orders(missing128, counts128, offsets128, P128)
    if sk.LAUNCHES["rarest_keys.sort"] != before + 1:
        fail("rarest_orders at P=128 did not take the sort route")
    check("rarest_keys", f"R={R128} P={P128} sort route (keys kernel + "
          "torch.sort)", got, want,
          nbytes(counts128, offsets128, missing128, got),
          R128 * P128 * (8 + int(np.log2(P128))),
          lambda: sk.rarest_orders(missing128, counts128, offsets128, P128),
          lambda: sk.rarest_orders_plain(counts128, offsets128, P128,
                                         missing=missing128),
          library=lambda: torch.sort(keys128, dim=1, stable=True).indices)

    # ---- island_has: v1, the reduction alone ---------------------------- #
    for N, K in ((500, 8), (2000, 8)):
        have = up((rs.random((N, P)) < 0.05).astype(np.uint8))
        isl = rs.integers(0, K, N)
        member = np.zeros((K, N), dtype=np.uint8)
        member[isl, np.arange(N)] = 1
        member = up(member)
        torch.cuda.synchronize()
        if not torch.equal(sk.island_has(have, member),
                           sk.island_has_plain(have, member)):
            fail(f"island_has (v1) N={N} K={K} disagrees with its plain "
                 "version")
        log(f"[kernel] island_has v1 N={N} K={K} P={P}: exact")

    # ---- island_has: v2 fuses the hub's P4P cost plane ----------------- #
    # (from a generator of its own, so the cases after it keep their
    # inputs).  The hub's planes at its capacity (the next power of two),
    # rows [0, N) reduced, R = N leecher rows in any order.  The third
    # case: 30% dead rows, 20% full rows, island 7 empty.
    rs_isl = np.random.default_rng(2221)
    K = 8
    for N, p_alive, p_full, k_used in ((500, 0.97, 0.02, K),
                                       (2000, 0.97, 0.02, K),
                                       (500, 0.7, 0.2, K - 1)):
        cap = 1 << (N - 1).bit_length()
        have = up((rs_isl.random((cap, P)) < 0.05).astype(np.uint8))
        full = up((rs_isl.random(cap) < p_full).astype(np.uint8))
        alive = up((rs_isl.random(cap) < p_alive).astype(np.uint8))
        island = up(rs_isl.integers(0, k_used, cap).astype(np.int64))
        rows = up(rs_isl.permutation(N).astype(np.int64))
        cost_k = rs_isl.integers(1, 16, (K, K))
        np.fill_diagonal(cost_k, 0)
        cost_k = up(cost_k.astype(np.int64))
        args = (have, full, alive, island, N, rows, cost_k)

        def v2(a=args):
            return sk.island_cost_rows(*a)

        one = torch.ones((), dtype=torch.uint8, device=dev)

        def v1(a=args, N=N, graph=False):
            # the composition the hub ran before v2, ~11 launches; in a
            # CUDA graph the member matrix's 1 comes from the card (a host
            # scalar's copy cannot be captured)
            h, f, al, isl, _, r, c = a
            plane = (h[:N] | f[:N, None]) & al[:N, None]
            member = torch.zeros((K, N), dtype=torch.uint8, device=dev)
            member[isl[:N], torch.arange(N, device=dev)] = one if graph \
                else 1
            return sk.min_island_cost(sk.island_has(plane, member),
                                      c)[isl[r]]

        v1_graph = functools.partial(v1, graph=True)

        plane = (have[:N] | full[:N, None]) & alive[:N, None]
        member = torch.zeros((K, N), dtype=torch.uint8, device=dev)
        member[island[:N], torch.arange(N, device=dev)] = 1
        got, want = v2(), sk.island_cost_rows_plain(*args)
        if not (torch.equal(v1(), want) and torch.equal(v1_graph(), want)):
            fail(f"island_has v1 composition N={N} disagrees")
        case = (f"island_cost_rows N={N} K={K} P={P} R={N}"
                + ("" if k_used == K else " 30% dead, 20% full, an empty "
                   "island"))
        mf, hf = member.float(), plane.float()
        check("island_has", case, got, want,
              nbytes(have[:N], full[:N], alive[:N], island[:N], rows,
                     cost_k, got),
              N * P * 2 + K * K * P + N * P, v2,
              lambda a=args: sk.island_cost_rows_plain(*a),
              library=lambda h=hf, m=mf: (m @ h) > 0)
        turns = [device_ms(f) for f in (v1_graph, v2, v2, v1_graph)]
        v1_call = call_ms(v1)
        rec = records["island_has"][-1]
        rec.update(v1_ms=(turns[0] + turns[3]) / 2, v1_call_ms=v1_call)
        log(f"[kernel] island_has {case}: turns (v1 composition, v2, v2, "
            f"v1) {' '.join(f'{t:.5f}' for t in turns)} ms; one call as "
            f"issued: v2 {rec['call_ms']:.5f}, v1 {v1_call:.5f} ms")

    # ---- match_requests: dense, then ragged (CSR) rows ----------------- #
    N = 2000
    have = up((rs.random((N, P)) < 0.3).astype(np.uint8))
    full = up((rs.random(N) < 0.01).astype(np.uint8))
    rank = rs.permutation(N)
    orders = up(np.stack([rs.permutation(P) for _ in range(R)])
                .astype(np.int32))
    n_walk = up(rs.integers(0, P + 1, R).astype(np.int32))
    budgets = up(rs.integers(0, 5, R).astype(np.int32))
    # data-dependent work: the steps this data walks, each testing every
    # candidate of the row
    walked = torch.minimum(n_walk, torch.full_like(n_walk, P)).long()
    for C in (8, 32, 128, 512):
        cand_np = np.stack([rs.choice(N, C, replace=False)
                            for _ in range(R)]).astype(np.int32)
        cand = up(cand_np)
        cand_ok = up((rs.random((R, C)) < 0.8).astype(np.uint8))
        key = up((rs.integers(0, 4, (R, C)) * 2 ** 20 + rank[cand_np])
                 .astype(np.int32))
        args = (orders, n_walk, budgets, cand, cand_ok, key, have, full)
        got = sk.match_requests(*args)
        want = sk.match_requests_plain(*args)
        check("match_requests", f"R={R} P={P} C={C} N={N}", got, want,
              nbytes(orders, n_walk, budgets, cand, cand_ok, key, have,
                     full, got), int(walked.sum()) * C * 4,
              lambda a=args: sk.match_requests(*a),
              lambda a=args: sk.match_requests_plain(*a))
    # Scenario X's width: 128 pieces, a swarm of 201 rows, the wide route
    N128 = 201
    have128 = up((rs128.random((N128, P128)) < 0.3).astype(np.uint8))
    full128 = up((rs128.random(N128) < 0.02).astype(np.uint8))
    rank128 = rs128.permutation(N128)
    orders128 = up(np.stack([rs128.permutation(P128) for _ in range(R128)])
                   .astype(np.int32))
    walk128 = up(rs128.integers(0, P128 + 1, R128).astype(np.int32))
    budgets128 = up(rs128.integers(0, 5, R128).astype(np.int32))
    walked128 = walk128.long()
    for C in (8, 64, 200):
        cand_np = np.stack([rs128.choice(N128, C, replace=False)
                            for _ in range(R128)]).astype(np.int32)
        cand = up(cand_np)
        cand_ok = up((rs128.random((R128, C)) < 0.8).astype(np.uint8))
        key = up((rs128.integers(0, 4, (R128, C)) * 2 ** 20
                  + rank128[cand_np]).astype(np.int32))
        args = (orders128, walk128, budgets128, cand, cand_ok, key, have128,
                full128)
        before = sk.LAUNCHES["match_requests.wide"]
        got = sk.match_requests(*args)
        if sk.LAUNCHES["match_requests.wide"] != before + 1:
            fail(f"match_requests at P={P128} C={C} took another route")
        want = sk.match_requests_plain(*args)
        check("match_requests", f"R={R128} P={P128} C={C} N={N128} wide "
              "route", got, want, nbytes(*args, got),
              int(walked128.sum()) * C * 4,
              lambda a=args: sk.match_requests(*a),
              lambda a=args: sk.match_requests_plain(*a))
    # a pump's shape: the pump's order rows (more than the matched rows,
    # read through row_of), each row its own degree: 1900 rows of degree
    # 1-64 and 1-600, and a pump as Scenario VII at N=2000 launches one
    # (40 rows, degrees 1-53 but one of 1100 and one of 1900)
    for name, hi, sub in (("1-64", 64, 1900), ("1-600", 600, 1900),
                          ("VII-like", 53, 40)):
        deg = np.minimum(np.exp(rs.uniform(0, np.log(hi + 1), R))
                         .astype(np.int64), hi)
        deg = np.maximum(deg, 1)
        deg[0] = hi
        if name == "VII-like":
            deg[3], deg[17] = 1900, 1100
        ptr_np = np.zeros(R + 1, dtype=np.int64)
        np.cumsum(deg, out=ptr_np[1:])
        nnz = int(ptr_np[-1])
        cand_np = rs.integers(0, N, nnz).astype(np.int32)
        row_of = up(rs.permutation(R)[:sub].astype(np.int32))
        ptr = up(ptr_np[: sub + 1].astype(np.int32))
        n_sub = int(ptr_np[sub])
        cand = up(cand_np[:n_sub])
        cand_ok = up((rs.random(n_sub) < 0.8).astype(np.uint8))
        key = up((rs.integers(0, 4, n_sub) * 2 ** 20
                  + rank[cand_np[:n_sub]]).astype(np.int32))
        dmax = int(deg[:sub].max())
        args = (orders, row_of, ptr, cand, cand_ok, key, n_walk[:sub],
                budgets[:sub], have, full)
        host_ptr = ptr_np[: sub + 1]
        got = sk.match_requests_ragged(*args, cand_ptr_host=host_ptr)
        want = sk.match_requests_ragged_plain(*args)
        steps = walked[:sub]
        check("match_requests", f"ragged R={sub} P={P} degrees {name} "
              f"(nnz={n_sub}, route {sk._match_route(P, dmax)}) N={N}",
              got, want, nbytes(*args[:8], have, full, got),
              int((steps * torch.from_numpy(deg[:sub]).to(dev)).sum()) * 4,
              lambda a=args, h=host_ptr: sk.match_requests_ragged(
                  *a, cand_ptr_host=h),
              lambda a=args: sk.match_requests_ragged_plain(*a))
    return records


# ======================== end-to-end phase ============================== #
SWARM_KERNELS = ("rarest_keys", "island_cost_rows", "match_requests")


def pump_launches(what, launched, n_pieces=None):
    """Every pump launches the piece orders once, on the route its width
    picks (`n_pieces` <= 64: the fused warp kernel; wider: the keys
    kernel + `torch.sort`, and the matcher's wide route only), and the
    matcher at most once: fail otherwise.  Without `n_pieces` (a run
    mixing widths) every pump took one of the two order routes.  Prints
    the launches per route and per pump."""
    pumps = launched["rarest_keys"]
    warp, srt = launched["rarest_keys.warp"], launched["rarest_keys.sort"]
    if n_pieces is None:
        want = (warp + srt, 0)
    elif n_pieces <= 64:
        want = (warp, srt)
    else:
        want = (srt, warp + launched["match_requests.reg"])
    if pumps <= 0 or want != (pumps, 0):
        fail(f"{what}: {pumps} pumps did not all take the piece orders' "
             f"route for {n_pieces} pieces: {json.dumps(launched)}")
    if n_pieces is not None and n_pieces > 64 \
            and launched["match_requests.wide"] <= 0:
        fail(f"{what}: the matcher's wide route never launched")
    if launched["match_requests"] > pumps:
        fail(f"{what}: {launched['match_requests']} matcher launches over "
             f"{pumps} pumps")
    if launched["island_has"] != 0:
        fail(f"{what}: the hub launched the v1 island_has "
             f"{launched['island_has']} times")
    log(f"[e2e] {what} launches by route {json.dumps(launched)}; per pump: "
        f"matcher {launched['match_requests'] / max(pumps, 1):.3f}, "
        f"island_cost_rows {launched['island_cost_rows'] / max(pumps, 1):.3f}")


# the pump's timed calls: piece orders and the matcher
PUMP_CALLS = ("_orders", "_match_call")


class HubCalls:
    """Counts, for each hub in the order the run made them, its timed
    kernel calls (`SwarmHub._kernel`, what `kernel_wall_s` adds up), the
    pump's share of them (piece orders and matcher, the calls PR 15's
    ms-per-call counted), and its pumps that order pieces under a
    topology (each must launch `island_cost_rows` exactly once), by
    wrapping the two methods while the run lasts."""

    def __init__(self):
        self.calls = {}
        self.cost_pumps = {}

    @property
    def n_cost_pumps(self):
        return sum(self.cost_pumps.values())

    def __enter__(self):
        from repro_torch.core.swarm_arrays import SwarmHub
        self.saved = SwarmHub._orders, SwarmHub._kernel
        orders, kernel = self.saved

        # keyed by the hub itself (held until the run ends), so a hub
        # freed after its arm cannot lend its id to the next one
        @functools.wraps(orders)
        def counted_orders(hub, st, rows, missing):
            self.cost_pumps.setdefault(hub, 0)
            if hub.cost_matrix is not None and len(rows) > 0:
                self.cost_pumps[hub] += 1
            return orders(hub, st, rows, missing)

        def counted_kernel(hub, fn, *args, **kw):
            n = self.calls.setdefault(hub, [0, 0])
            n[0] += 1
            n[1] += getattr(fn, "__name__", "") in PUMP_CALLS
            return kernel(hub, fn, *args, **kw)

        SwarmHub._orders, SwarmHub._kernel = counted_orders, counted_kernel
        return self

    def __exit__(self, *exc):
        from repro_torch.core.swarm_arrays import SwarmHub
        SwarmHub._orders, SwarmHub._kernel = self.saved

    def per_arm(self, arms):
        """(kernel calls, pump calls, P4P pumps) of each arm, or None
        where the run made another number of hubs than it has arms."""
        if len(self.calls) != len(arms):
            return [None] * len(arms)
        return [(n[0], n[1], self.cost_pumps.get(h, 0))
                for h, n in self.calls.items()]


def run_entry(scenarios, entry, device):
    """One entry of reference_runs.json on `device`: (result, arms), the
    arms being the per-hub results that carry the hub's stats.  A
    "chaos" entry is one `ChaosScenario` whose invariants (the device
    planes' among them) are checked here; `scenario_viii` checks both of
    its arms' itself."""
    scenario, params = entry["scenario"], entry["params"]
    if scenario == "chaos":
        from repro_torch.core.chaos import ChaosScenario
        sc = ChaosScenario(device=device, **params).run()
        sc.check_invariants()
        res = dict(sc.report(), device=str(sc.hub.device))
        return res, [res]
    res = getattr(scenarios, scenario)(verbose=False, device=device,
                                       **params)
    arms = {"scenario_ix": ("naive", "p4p"),
            "scenario_viii": ("baseline", "chaos")}.get(scenario)
    return res, [res[a] for a in arms] if arms else [res]


def entry_pieces(scenarios, entry):
    """The piece count of an entry's swarm: its parameter, else the
    scenario's default."""
    import inspect
    params = entry["params"]
    if "n_pieces" in params:
        return params["n_pieces"]
    fn = getattr(scenarios, entry["scenario"])
    return inspect.signature(fn).parameters["n_pieces"].default


def end_to_end_phase(torch, sk, scenarios, names=CHIP_RUNS, device="cuda"):
    """Drive each entry on the card: its virtual-time results must equal
    reference_runs.json, and each run's launches must follow its width's
    routes.  (``names`` and ``device`` let it be rehearsed small on the
    CPU, where nothing launches.)"""
    golden = json.loads(RUNS_FILE.read_text())
    if golden.get("pythonhashseed") != os.environ.get("PYTHONHASHSEED"):
        fail("expected values were taken under another PYTHONHASHSEED")
    for name in names:
        entry = golden["runs"][name]
        before = dict(sk.LAUNCHES)
        t0 = time.perf_counter()
        with HubCalls() as hub_calls:
            res, arms = run_entry(scenarios, entry, device)
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not (res.get("done", True) and res["replicated"]):
            fail(f"{name}: done={res.get('done')} "
                 f"replicated={res['replicated']}")
        if entry["scenario"] == "scenario_x" and not (
                res["upgraded"] and res["chaos_ready"] and res["no_stale"]
                and res["stale_accepts"] == 0):
            fail(f"{name}: upgraded={res['upgraded']} chaos_ready="
                 f"{res['chaos_ready']} stale_accepts={res['stale_accepts']}")
        devs = {d for d in [res.get("device")]
                + [a.get("device") for a in arms] if d}
        if not devs or any(not d.startswith(device) for d in devs):
            fail(f"{name}: ran on {sorted(devs)}")
        got = scenarios.virtual_time_fields(entry["scenario"], res)
        launched = {k: sk.LAUNCHES[k] - before[k] for k in sk.LAUNCHES}
        n_pieces = entry_pieces(scenarios, entry)
        n_cost = hub_calls.n_cost_pumps
        if entry["params"].get("n_islands", 0) > 0 and n_cost <= 0:
            fail(f"{name}: no pump ordered pieces under the topology")
        if device == "cuda":
            pump_launches(name, launched, n_pieces)
            if launched["island_cost_rows"] != n_cost:
                fail(f"{name}: {launched['island_cost_rows']} "
                     f"island_cost_rows launches over {n_cost} P4P pumps")

        def calls(a, counts):
            if counts is None:
                return ""
            ms = a["kernel_wall_s"] * 1e3
            return (f" kernel_calls={counts[0]} ms_per_call="
                    f"{ms / max(counts[0], 1):.4f} pump_calls={counts[1]} "
                    f"ms_per_pump_call={ms / max(counts[1], 1):.4f} "
                    f"P4P_pumps={counts[2]}")

        log(f"[e2e] {name} {json.dumps(entry['params'])} P={n_pieces}: "
            f"wall_s={wall:.3f} " + " | ".join(
                f"events={a.get('events')} "
                f"tick_wall_s={a['tick_wall_s']:.3f} "
                f"kernel_wall_s={a['kernel_wall_s']:.3f} "
                f"batch_ops={a['batch_ops']}"
                + (f" drain_wall_s={a['drain_wall_s']:.3f}"
                   if "drain_wall_s" in a else "") + calls(a, c)
                for a, c in zip(arms, hub_calls.per_arm(arms)))
            + f" launches={json.dumps(launched)}")
        log(f"[e2e] {name} result {json.dumps(got)}")
        log(f"[time] {name} {wall:.1f}s")
        if got != entry["result"]:
            log(f"[e2e] {name} MISMATCH against reference_runs.json: "
                f"expected {json.dumps(entry['result'])}")
            if device == "cuda":
                cpu = scenarios.virtual_time_fields(
                    entry["scenario"], run_entry(scenarios, entry, "cpu")[0])
                log(f"[e2e] {name} port on the CPU "
                    + ("matches" if cpu == entry["result"] else
                       f"does not match either: {json.dumps(cpu)}"))
            fail(f"{name}: {device} results differ from "
                 "reference_runs.json")


# ====================== serve slice: kernel phase ======================= #
def live_pairs(Sq, Skv, causal, window):
    """(query, key) pairs alive under the mask: the work attention needs."""
    n = 0
    for qpos in range(Sq):
        hi = min(Skv - 1, qpos) if causal else Skv - 1
        lo = max(0, qpos - window + 1) if window else 0
        n += max(0, hi - lo + 1)
    return n


def ssd_ops(B, S, H, P, N, chunk):
    """FLOP of the chunked scan over the real steps: per chunk of Lc steps
    the causal half of C B^T and of its product with x dt, Lc(Lc+1)(N+P),
    plus the state's read and update, 4 Lc N P."""
    L = min(chunk, S)
    ops = 0
    for t0 in range(0, S, L):
        lc = min(L, S - t0)
        ops += lc * (lc + 1) * (N + P) + 4 * lc * N * P
    return ops * B * H


def model_kernel_phase(torch):
    """`flash_fwd` and `ssd_scan` against their plain versions on CUDA
    tensors: the reference's kernel-test cases, then the serve path's
    shapes (timed; the last record of each kernel is the reported one)."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssd import kernel as ssk
    rs = np.random.default_rng(2024)
    records = {}

    def up(shape, dtype, scale=1.0):
        a = (rs.standard_normal(shape) * scale).astype(np.float32)
        return torch.from_numpy(a).cuda().to(dtype)

    def check(name, case, got, want, tol, what, relative=False):
        """max |got - want| within tol (of max |want| when relative)."""
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max()) if relative else 1.0
        if not err <= tol * scale:
            fail(f"{name} [{case}] {what} off by {err:.3e} > {tol:.1e}"
                 f"{' of max ' + str(scale) if relative else ''} from its "
                 "plain version")
        records.setdefault(name, []).append(
            {"case": case, "max_abs_err": err})
        log(f"[kernel] {name} {case}: {what} max abs err {err:.3e} "
            f"(tolerance {tol:.0e}{' of max ' + f'{scale:.3f}' if relative else ''})")

    def timed(name, kernel, v1, plain, n_bytes, n_ops, peak, library=None):
        """Device ms of the kernel and of its CUDA-core version v1, in
        turns (v1, v2, v2, v1), each the mean of its two turns."""
        turns = [device_ms(f, reps=10, inner=3)
                 for f in (v1, kernel, kernel, v1)]
        ms, v1_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
        ms_call = call_ms(kernel, reps=10)
        plain_ms = call_ms(plain, reps=5)
        lib_ms = device_ms(library, reps=10, inner=3) if library else None
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_ops / peak * 1e3
        b_ms, b_by = ((t_bytes, "bytes") if t_bytes >= t_ops
                      else (t_ops, "operations"))
        rec = records[name][-1]
        rec.update(ms=ms, v1_ms=v1_ms, call_ms=ms_call, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                   bytes=n_bytes, ops=n_ops)
        log(f"[kernel] {name} {rec['case']}: ms={ms:.4f} (turns v1 v2 v2 v1 "
            f"{' '.join(f'{x:.4f}' for x in turns)}; one call as issued "
            f"{ms_call:.4f}) v1_ms={v1_ms:.4f} plain_ms={plain_ms:.3f} "
            f"bytes={n_bytes} "
            f"ops={n_ops} bound_ms={b_ms:.4f} ({b_by})"
            + (f" library_ms={lib_ms:.4f}" if lib_ms is not None else ""))

    # ---- flash_fwd ------------------------------------------------------ #
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        for B, Sq, Skv, Hq, Hkv, D, causal, window in FLASH_CASES:
            q, k, v = (up(s, dtype) for s in ((B, Sq, Hq, D),
                                              (B, Skv, Hkv, D),
                                              (B, Skv, Hkv, D)))
            out, lse = fk.flash_fwd(q, k, v, causal=causal, window=window)
            want, wlse = fk.flash_fwd_plain(q, k, v, causal=causal,
                                            window=window)
            case = f"{(B, Sq, Skv, Hq, Hkv, D, causal, window)} {dtype}"
            check("flash_fwd", case, out, want, tol, "out")
            check("flash_fwd", case, lse, wlse,
                  1e-4 if dtype == torch.float32 else 2e-2, "lse")
    B, S, H, D = 4, 2048, 32, 112
    q, k, v = (up((B, S, H, D), torch.bfloat16) for _ in range(3))
    out, lse = fk.flash_fwd(q, k, v, causal=True)
    want, _ = fk.flash_fwd_plain(q, k, v, causal=True)
    check("flash_fwd", f"B={B} S={S} H={H} D={D} causal bf16", out, want,
          2e-2, "out")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    timed("flash_fwd",
          lambda: fk.flash_fwd(q, k, v, causal=True),
          lambda: fk.flash_fwd_v1(q, k, v, causal=True),
          lambda: fk.flash_fwd_plain(q, k, v, causal=True),
          4 * q.numel() * q.element_size() + lse.numel() * 4,
          4 * B * H * D * live_pairs(S, S, True, 0), BF16_OPS_PER_S,
          library=lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                         is_causal=True))
    del q, k, v, qt, kt, vt, out, lse, want
    # the train step's shape (B=2: the 13-layer zamba2 of train_step_phase)
    q, k, v = (up((2, S, H, D), torch.bfloat16) for _ in range(3))
    out, _ = fk.flash_fwd(q, k, v, causal=True)
    want, _ = fk.flash_fwd_plain(q, k, v, causal=True)
    check("flash_fwd", f"B=2 S={S} H={H} D={D} causal bf16 (train step)",
          out, want, 2e-2, "out")
    del q, k, v, out, want

    # ---- ssd_scan -------------------------------------------------------- #
    def ssd_inputs(B, S, H, P, G, N, dtype):
        x = up((B, S, H, P), dtype)
        dt = torch.nn.functional.softplus(up((B, S, H), torch.float32))
        A = -torch.exp(up((H,), torch.float32, 0.3))
        return (x, dt.contiguous(), A.contiguous(),
                up((B, S, G, N), dtype, 0.5), up((B, S, G, N), dtype, 0.5))

    for B, S, H, P, G, N, chunk in SSD_CASES:
        args = ssd_inputs(B, S, H, P, G, N, torch.float32)
        y, fin = ssk.ssd_scan(*args, chunk=chunk)
        wy, wfin = ssk.ssd_scan_plain(*args, chunk=chunk)
        case = f"{(B, S, H, P, G, N, chunk)} f32"
        check("ssd_scan", case, y, wy, 1e-3, "y")
        check("ssd_scan", case, fin, wfin, 1e-3, "state")
    # f16 whose M = C B^T exp(segsum) dt passes f16's 65504 inside a chunk
    # while y and the state fit: f16 takes the CUDA-core kernel, M in f32
    rs16 = np.random.default_rng(65504)
    B, S, H, P, N, chunk = 1, 200, 2, 64, 64, 64

    def f32(a):
        return torch.from_numpy(a.astype(np.float32)).cuda()

    args = (f32(rs16.standard_normal((B, S, H, P)) * 1e-3).half(),
            f32(1.0 + 0.1 * rs16.random((B, S, H))),
            f32(np.full(H, -0.01)),
            f32(40 + rs16.random((B, S, 1, N))).half(),
            f32(40 + rs16.random((B, S, 1, N))).half())
    n0 = dict(ssk.LAUNCHES)
    y, fin = ssk.ssd_scan(*args, chunk=chunk)
    if ssk.LAUNCHES["ssd_scan.mma"] != n0["ssd_scan.mma"]:
        fail("ssd_scan took the tensor-core route for f16")
    wy, wfin = ssk.ssd_scan_plain(*args, chunk=chunk)
    case = f"{(B, S, H, P, 1, N, chunk)} f16, |M| > 65504"
    check("ssd_scan", case, y, wy, 1e-2, "y", relative=True)
    check("ssd_scan", case, fin, wfin, 1e-2, "state", relative=True)
    B, S, H, P, G, N, chunk = 4, 2048, 112, 64, 1, 64, 256
    args = ssd_inputs(B, S, H, P, G, N, torch.bfloat16)
    y, fin = ssk.ssd_scan(*args, chunk=chunk)
    wy, wfin = ssk.ssd_scan_plain(*args, chunk=chunk)
    case = f"B={B} S={S} H={H} P={P} G={G} N={N} chunk={chunk} bf16"
    check("ssd_scan", case, y, wy, 1e-2, "y", relative=True)
    check("ssd_scan", case, fin, wfin, 1e-2, "state", relative=True)
    timed("ssd_scan",
          lambda: ssk.ssd_scan(*args, chunk=chunk),
          lambda: ssk.ssd_scan_v1(*args, chunk=chunk),
          lambda: ssk.ssd_scan_plain(*args, chunk=chunk),
          sum(t.numel() * t.element_size() for t in (*args, y, fin)),
          ssd_ops(B, S, H, P, N, chunk), BF16_OPS_PER_S)
    args = ssd_inputs(2, S, H, P, G, N, torch.bfloat16)
    y, fin = ssk.ssd_scan(*args, chunk=chunk)
    wy, wfin = ssk.ssd_scan_plain(*args, chunk=chunk)
    case = f"B=2 S={S} H={H} P={P} G={G} N={N} chunk={chunk} bf16 (train)"
    check("ssd_scan", case, y, wy, 1e-2, "y", relative=True)
    check("ssd_scan", case, fin, wfin, 1e-2, "state", relative=True)
    return records


# ================= serve slice: against the reference =================== #
def model_launches():
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssd import kernel as ssk
    return {**fk.LAUNCHES, **ssk.LAUNCHES}


def reset_model_launches():
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssd import kernel as ssk
    fk.reset_launches()
    ssk.reset_launches()


def route_counts(n_flash, n_ssd, n_flash_mma, n_ssd_mma):
    return {"flash_fwd": n_flash, "flash_fwd.mma": n_flash_mma,
            "ssd_scan": n_ssd, "ssd_scan.mma": n_ssd_mma}


def layer_counts(cfg):
    n_ssd = sum(g.repeat * sum(ls.mixer == "ssd" for ls in g.layers)
                for g in cfg.groups)
    n_attn = sum(g.repeat * sum(ls.shared_attn for ls in g.layers)
                 for g in cfg.groups)
    return n_ssd, n_attn


def serve_reference_config(ref):
    """The model `reference_serve.json` was taken on: zamba2-7b at full
    width, cut to its groups, in its dtype, with the kernels."""
    from repro_torch.configs.base import GroupSpec, LayerSpec, get_config
    groups = tuple(GroupSpec(tuple(LayerSpec(*ls) for ls in layers), r)
                   for layers, r in ref["groups"])
    return get_config(ref["arch"]).replace(dtype=ref["dtype"],
                                           use_pallas=True, groups=groups)


def serve_reference_phase(torch, device="cuda"):
    """zamba2-7b at full width, cut to 7 layers, f32 with the kernels,
    against the reference package's prefill and decode logits."""
    import numpy as np
    from repro_torch.models import model as M
    from repro_torch.models.convert import params_from_reference
    from repro_torch.parallel.sharding import (init_params,
                                               init_params_numpy,
                                               tree_leaves_with_path)
    ref = json.loads(SERVE_FILE.read_text())
    cfg = serve_reference_config(ref)
    specs = M.model_param_specs(cfg)
    t0 = time.perf_counter()
    tree = init_params_numpy(ref["seed"], specs)
    for path, a in tree_leaves_with_path(tree):
        want = ref["weight_abs_sums"].get(path)
        if want is not None and abs(float(np.sum(np.abs(a),
                                                 dtype=np.float64))
                                    - want) > 1e-9 * want:
            fail(f"weights drawn here differ from the reference's: {path}")
    params = params_from_reference(tree, specs, device=device)
    del tree
    log(f"[serve-ref] {ref['arch']} {len(ref['groups'])} groups, "
        f"{M.count_params(cfg)} params drawn and loaded in "
        f"{time.perf_counter() - t0:.1f}s")
    n_prompt, n_dec = len(ref["prompt"]), ref["decode_steps"]
    caches = init_params(0, M.cache_specs_tree(cfg, 1, n_prompt + n_dec),
                         device=device)
    idx = torch.tensor(ref["logit_index"], device=device)
    tol = ref["tolerance"]
    reset_model_launches()
    t0 = time.perf_counter()
    worst = 0.0
    with torch.no_grad():
        logits, caches = M.prefill(
            cfg, params, {"tokens": torch.tensor([ref["prompt"]],
                                                 dtype=torch.int32,
                                                 device=device)}, caches)
        for i, step in enumerate(ref["steps"]):
            lg = logits[0].float()
            tok = int(torch.argmax(lg))
            max_abs = float(lg.abs().max())
            err = float(np.max(np.abs(lg[idx].cpu().numpy()
                                      - np.asarray(step["values"]))))
            rel = max(err, abs(max_abs - step["max_abs"])) / step["max_abs"]
            worst = max(worst, rel)
            log(f"[serve-ref] step {i}: token {tok} (reference "
                f"{step['token']}) max|logit| {max_abs:.5f} (reference "
                f"{step['max_abs']:.5f}) err {rel:.2e} of max|logit|")
            if tok != step["token"] or rel > tol:
                fail(f"7-layer zamba2 step {i} differs from "
                     "reference_serve.json")
            if i == n_dec:
                break
            logits, caches = M.decode_step(
                cfg, params, {"tokens": torch.tensor(
                    [[step["token"]]], dtype=torch.int32, device=device)},
                caches)
    launched = model_launches()
    n_ssd, n_attn = layer_counts(cfg)
    # f32: every launch on the CUDA-core kernels
    want = route_counts(n_attn, n_ssd, 0, 0) if device == "cuda" \
        else route_counts(0, 0, 0, 0)
    if launched != want:
        fail(f"7-layer prefill launched {launched}, expected {want}")
    log(f"[serve-ref] matches reference_serve.json (worst {worst:.2e} of "
        f"max|logit| <= {tol}) in {time.perf_counter() - t0:.1f}s, "
        f"launches {json.dumps(launched)}")
    return worst


# ===================== serve slice: the full model ====================== #
def sync(torch, device):
    if device == "cuda":
        torch.cuda.synchronize()


# the kernels' names in a device trace, tensor-core and CUDA-core
MODEL_KERNELS = ("flash_fwd_mma_kernel", "flash_fwd_kernel",
                 "ssd_scan_mma_kernel", "ssd_scan_kernel")


def profile_step(torch, what, fn):
    """Device time of one call by kernel class, from torch.profiler's
    kernel events, beside the host clock around it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    sums = {"ssd_scan": 0.0, "flash_fwd": 0.0, "gemm": 0.0, "other": 0.0}
    kernels = dict.fromkeys(MODEL_KERNELS, 0)
    names, n = {}, 0
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        ms = evt.time_range.elapsed_us() / 1e3
        name = evt.name
        low = name.lower()
        n += 1
        names[name] = names.get(name, 0.0) + ms
        for kname in MODEL_KERNELS:
            if kname in low:
                kernels[kname] += 1
        if "ssd_scan_" in low:
            sums["ssd_scan"] += ms
        elif "flash_fwd_" in low:
            sums["flash_fwd"] += ms
        elif any(t in low for t in ("gemm", "xmma", "cutlass", "nvjet",
                                    "cublas")):
            sums["gemm"] += ms
        else:
            sums["other"] += ms
    busy = sum(sums.values())
    top = sorted(names.items(), key=lambda kv: -kv[1])[:8]
    log(f"[profile] {what}: wall_ms={wall:.1f} (under the profiler) "
        f"kernels={n} device_ms={busy:.1f} "
        f"{json.dumps({k: round(v, 3) for k, v in sums.items()})} idle share "
        f"{max(0.0, 1 - busy / wall):.3f}; model kernels launched "
        f"{json.dumps(kernels)}; top "
        f"{json.dumps([(k[:60], round(v, 3)) for k, v in top])}")
    return kernels


def condition_attention(cfg, params):
    """Scale the shared attention's projections to a fan-in of d_model for
    wq/wk/wv and of heads*head_dim for wo.  The reference's init rule takes
    shape[-2] of a rank-3 weight as its fan-in, the head count here, so
    q/k/v come out ~10x too large, the softmax saturates and the random
    model amplifies any rounding difference ~10x per attention
    application (13 of them): no two implementations then agree end to
    end.  Returns the same tree, scaled in place."""
    a = params["shared_attn"]["attn"]
    heads = cfg.shared_attn_heads or cfg.num_heads
    for name in ("wq", "wk", "wv"):
        a[name].mul_((heads / cfg.d_model) ** 0.5)
    a["wo"].mul_((1.0 / heads) ** 0.5)
    return params


def layerwise_prefill_check(torch, params, cfg, prompts, cache_len, tol):
    """Each of the model's layers on the same input through the kernels and
    through the plain torch paths (teacher-forced at the layer: the next
    layer's input is the kernel path's output); holds each layer's output
    and the caches it writes within ``tol`` of the plain path's max."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import init_params
    ck, cp = cfg.replace(use_pallas=True), cfg.replace(use_pallas=False)
    B, S = prompts.shape
    dev = prompts.device
    worst = {"out": 0.0, "ssm": 0.0, "shared_kv": 0.0}
    with torch.no_grad():
        x = L.embed_tokens(params["embed"], prompts, cfg)
        pos = torch.broadcast_to(torch.arange(S, device=dev), (B, S))
        aux = torch.zeros((), device=dev)
        for gi, g in enumerate(cfg.groups):
            gp = params["decoder"][f"g{gi}"]
            for r in range(g.repeat):
                ps = M._index_tree(gp, r)
                for li, ls in enumerate(g.layers):
                    spec = M.layer_cache_specs(cfg, ls, B, cache_len)
                    outs = []
                    for c in (ck, cp):
                        cache = init_params(0, spec, device=dev)
                        y, _, nc = M.apply_layer(
                            c, ls, ps[f"L{li}"], x, aux,
                            shared_params=params.get("shared_attn"),
                            mode="prefill", positions=pos, cache=cache)
                        outs.append((y, nc))
                    (yk, ncs), (yp, ncp) = outs

                    def rel(a, b):
                        return float((a.float() - b.float()).abs().max()
                                     / b.float().abs().max().clamp_min(1e-30))

                    errs = {"out": rel(yk, yp), "ssm": rel(ncs["ssm"],
                                                            ncp["ssm"])}
                    if ls.shared_attn:
                        errs["shared_kv"] = max(
                            rel(ncs["shared_k"], ncp["shared_k"]),
                            rel(ncs["shared_v"], ncp["shared_v"]))
                    for k, v in errs.items():
                        worst[k] = max(worst[k], v)
                    if max(errs.values()) > tol:
                        fail(f"layer g{gi} repeat {r} L{li}: the kernel "
                             f"path differs from the plain path by "
                             f"{json.dumps(errs)} > {tol}")
                    x = yk
    return worst


def full_model_phase(torch, params, cfg, prompts, device="cuda",
                     n_decode=32):
    """zamba2-7b at full depth and width in bf16 through the serve steps,
    with the kernels' launches counted over this run only; then the kernel
    path against the plain torch paths: layer by layer over the bf16
    prefill, and end to end (prefill + teacher-forced decode) in f32.
    ``params`` are the f32 master weights; the bf16 runs use a bf16 copy.
    (``cfg`` and ``device`` let it be rehearsed small on the CPU.)"""
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import init_params
    from repro_torch.training.train_state import (make_decode_step,
                                                  make_prefill_step)
    cfg16 = cfg.replace(dtype="bfloat16", use_pallas=True)
    cfg32 = cfg.replace(dtype="float32", use_pallas=True)
    n_ssd, n_attn = layer_counts(cfg)
    on_card = device == "cuda"

    def cast(tree):
        return ({k: cast(v) for k, v in tree.items()}
                if isinstance(tree, dict) else tree.to(torch.bfloat16))

    params16 = cast(params)
    B, S = prompts.shape
    cache_len = S + n_decode
    prefill_step = make_prefill_step(cfg16)
    decode_step = make_decode_step(cfg16)

    def fresh_caches(c):
        return init_params(0, M.cache_specs_tree(c, B, cache_len),
                           device=device)

    # warm-up (library handles, kernel attributes) on a shorter prompt
    prefill_step(params16, {"tokens": prompts[:, :S // 2 + 76]},
                 fresh_caches(cfg16))
    sync(torch, device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    # ---- the main path: counted and timed ------------------------------- #
    reset_model_launches()
    caches = fresh_caches(cfg16)
    sync(torch, device)
    t0 = time.perf_counter()
    tok, caches = prefill_step(params16, {"tokens": prompts}, caches)
    sync(torch, device)
    prefill_s = time.perf_counter() - t0
    per_prefill = model_launches()
    # bf16: every launch on the tensor-core kernels
    want = route_counts(n_attn, n_ssd, n_attn, n_ssd) if on_card \
        else route_counts(0, 0, 0, 0)
    if per_prefill != want:
        fail(f"the prefill launched {per_prefill}, expected {want}")
    toks = [tok]
    t0 = time.perf_counter()
    for _ in range(n_decode):
        tok, caches = decode_step(params16, {"tokens": tok[:, None]}, caches)
        toks.append(tok)
    sync(torch, device)
    decode_ms = (time.perf_counter() - t0) * 1e3 / n_decode
    launches = model_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else 0
    log(f"[full] zamba2-7b bf16, {M.count_params(cfg)} params ({n_ssd} SSD "
        f"layers, {n_attn} shared-attention applications): prefill B={B} "
        f"S={S} {prefill_s:.3f}s = {B * S / prefill_s:.0f} tokens/s; decode "
        f"{decode_ms:.2f} ms/step over {n_decode} steps (B={B}); peak "
        f"memory {peak_gb:.2f} GiB (with the f32 master weights); launches "
        f"{json.dumps(launches)}")
    if on_card:
        traced = profile_step(torch, "bf16 prefill", lambda: prefill_step(
            params16, {"tokens": prompts}, fresh_caches(cfg16)))
        want = {"flash_fwd_mma_kernel": n_attn, "flash_fwd_kernel": 0,
                "ssd_scan_mma_kernel": n_ssd, "ssd_scan_kernel": 0}
        if traced != want:
            fail(f"the traced prefill ran {traced}, expected {want}")
        profile_step(torch, "bf16 decode step", lambda: decode_step(
            params16, {"tokens": toks[-1][:, None]}, caches))
    del caches

    # ---- kernels against the plain paths -------------------------------- #
    t0 = time.perf_counter()
    worst = layerwise_prefill_check(torch, params16, cfg16, prompts,
                                    cache_len, 2e-2)
    log(f"[full] bf16 prefill, layer by layer on the same inputs: kernels "
        f"vs plain torch paths worst {json.dumps(worst)} of the plain "
        f"path's max (tolerance 2e-2) in {time.perf_counter() - t0:.1f}s")

    def logits_run(c, p):
        caches, out = fresh_caches(c), []
        with torch.no_grad():
            lg, caches = M.prefill(c, p, {"tokens": prompts}, caches)
            out.append(lg.float())
            for i in range(n_decode):
                lg, caches = M.decode_step(
                    c, p, {"tokens": toks[i][:, None]}, caches)
                out.append(lg.float())
        return torch.stack(out)

    def rel(a, b):
        """worst step's max |a - b| over max |b|"""
        return max((a - b).abs().amax(dim=(1, 2))
                   / b.abs().amax(dim=(1, 2))).item()

    def agree(a, b):
        return float((a.argmax(-1) == b.argmax(-1)).float().mean())

    lk16 = logits_run(cfg16, params16)
    if not torch.equal(lk16.argmax(-1).int(), torch.stack(toks)):
        fail("the kernels' logits do not give the served tokens")
    if not bool(torch.isfinite(lk16).all()):
        fail("non-finite bf16 logits")
    lp16 = logits_run(cfg16.replace(use_pallas=False), params16)
    del params16
    lk32 = logits_run(cfg32, params)
    lp32 = logits_run(cfg32.replace(use_pallas=False), params)
    r32 = rel(lk32, lp32)
    log(f"[full] end to end over prefill + {n_decode} teacher-forced steps, "
        f"kernels vs plain torch paths: f32 {r32:.3e} of max|logit| "
        f"(greedy tokens agree {agree(lk32, lp32):.3f}); bf16 "
        f"{rel(lk16, lp16):.3e} ({agree(lk16, lp16):.3f}); bf16 against "
        f"f32, the dtype's own error: kernels {rel(lk16, lk32):.3e} "
        f"({agree(lk16, lk32):.3f}), plain {rel(lp16, lp32):.3e} "
        f"({agree(lp16, lp32):.3f})")
    if r32 > 2e-2:
        fail(f"f32 logits with the kernels differ from the plain paths by "
             f"{r32:.3e} of max|logit|")
    return launches


def greedy_decode(torch, cfg, params, prompt, n, device):
    """``n`` greedy tokens after ``prompt``, each from a full forward over
    the whole sequence so far (no caches)."""
    from repro_torch.models import model as M
    toks, out = [int(t) for t in prompt], []
    with torch.no_grad():
        for _ in range(n):
            logits, _, _ = M.forward(cfg, params, {"tokens": torch.tensor(
                [toks], dtype=torch.int32, device=device)}, mode="train")
            out.append(int(torch.argmax(logits[0, -1])))
            toks.append(out[-1])
    return out


def engine_phase(torch, params, cfg, device="cuda", seed=11, n_req=4,
                 max_new=8):
    """The port's ServingEngine on zamba2-7b at full depth in f32: each
    request's tokens against a full-forward greedy decode on the card."""
    import numpy as np
    from repro_torch.serving.engine import ServeConfig, ServingEngine
    cfg = cfg.replace(dtype="float32", use_pallas=True)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size,
                            int(rng.integers(8, 25))).astype(np.int32)
               for _ in range(n_req)]
    eng = ServingEngine(cfg, params, ServeConfig(slots=2, max_len=64),
                        device=device)
    for p in prompts:
        eng.submit(p, max_new=max_new)
    reqs = list(eng.queue)
    t0 = time.perf_counter()
    ticks = 0
    while eng.queue or eng.active:
        eng.step()
        ticks += 1
    sync(torch, device)
    wall = time.perf_counter() - t0
    for p, r in zip(prompts, reqs):
        ref = greedy_decode(torch, cfg, params, p, max_new, device)
        if r.out_tokens != ref:
            fail(f"engine request {r.req_id} gave {r.out_tokens}, "
                 f"full-forward greedy {ref}")
    units = {b: {"p": u["p"], "d": u["d"]}
             for b, u in eng.published_units().items()}
    log(f"[engine] zamba2-7b f32: {n_req} requests (prompts "
        f"{[len(p) for p in prompts]}), {ticks} ticks in {wall:.2f}s; every "
        f"request equals its full-forward greedy decode; published "
        f"{json.dumps(units)}")


def serve_full_phases(torch, cfg=None, device="cuda", B=4, S=2048,
                      seed=7, **kw):
    """Draw zamba2-7b's f32 master weights once on the card, then the
    full-model and the engine phases on them."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import init_params
    cfg = cfg or get_config("zamba2-7b")
    t0 = time.perf_counter()
    params = init_params(seed, M.model_param_specs(cfg), device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            device=device, dtype=torch.int32)
    sync(torch, device)
    log(f"[full] {M.count_params(cfg)} f32 weights drawn in "
        f"{time.perf_counter() - t0:.1f}s")

    def prefill_logits(c):
        caches = init_params(0, M.cache_specs_tree(c, B, S), device=device)
        with torch.no_grad():
            return M.prefill(c, params, {"tokens": prompts}, caches)[0]

    # the reference's init rule as it is: measured, not held to a bound
    c32 = cfg.replace(dtype="float32", use_pallas=True)
    lk = prefill_logits(c32)
    lp = prefill_logits(c32.replace(use_pallas=False))
    log(f"[full] reference init rule, f32 prefill: kernels vs plain torch "
        f"paths {float((lk - lp).abs().max() / lp.abs().max()):.3e} of "
        f"max|logit|, greedy tokens agree "
        f"{float((lk.argmax(-1) == lp.argmax(-1)).float().mean()):.3f}")
    del lk, lp
    condition_attention(cfg, params)
    log("[full] shared attention scaled to a fan-in of d_model")
    t0 = time.perf_counter()
    launches = full_model_phase(torch, params, cfg, prompts, device=device,
                                **kw)
    log(f"[time] full-model phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    engine_phase(torch, params, cfg, device=device)
    log(f"[time] engine phase {time.perf_counter() - t0:.1f}s")
    return launches


# ======================== train slice ================================== #
# device kernels by name, then the torch ops by the innermost of these CPU
# ranges that launched them: the remat recompute (its range sits inside
# whichever backward node first unpacked the checkpointed input), the
# autograd nodes of the two backwards, and the optimizer's range
TRAIN_RANGES = (("recompute", "remat_recompute"),
                ("ssd_bwd", "SSDScanBackward"),
                ("flash_bwd", "FlashAttentionBackward"),
                ("optimizer", "adamw_update"))
GEMM_TAGS = ("gemm", "xmma", "cutlass", "nvjet", "cublas")


def kernel_class(name):
    low = name.lower()
    if "flash_fwd_" in low:
        return "flash_fwd"
    if "ssd_scan_" in low:
        return "ssd_scan"
    if any(t in low for t in GEMM_TAGS):
        return "gemm"
    return "elementwise"


def range_class(evt):
    """The class of the innermost TRAIN_RANGES range around a CPU op, or
    None."""
    while evt is not None:
        for cls, tag in TRAIN_RANGES:
            if evt.name.endswith(tag):
                return cls
        evt = evt.cpu_parent
    return None


def profile_train_step(torch, fn, step_ms):
    """Device ms of one train step by class: the flash and SSD kernels
    (by name); then every other kernel by the innermost range that
    launched it: the remat recompute, the SSD backward's and the flash
    backward's torch ops (their autograd nodes), the optimizer (its
    range); the rest as GEMMs or elementwise.  The idle share is taken
    against ``step_ms``, the step's time without the profiler (which
    slows the host's launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    total = dict.fromkeys(("flash_fwd", "ssd_scan", "gemm", "elementwise"),
                          0.0)
    names, n = {}, 0
    for evt in events:
        if evt.device_type != DeviceType.CUDA or \
                getattr(evt, "is_user_annotation", False):
            continue
        ms = evt.time_range.elapsed_us() / 1e3
        total[kernel_class(evt.name)] += ms
        names[evt.name] = names.get(evt.name, 0.0) + ms
        n += 1
    inside = {cls: dict.fromkeys(total, 0.0) for cls, _ in TRAIN_RANGES}
    for evt in events:
        if evt.device_type != DeviceType.CPU or not evt.kernels:
            continue
        cls = range_class(evt)
        if cls is not None:
            for k in evt.kernels:
                inside[cls][kernel_class(k.name)] += k.duration / 1e3
    classes = {"flash_fwd": total["flash_fwd"],
               "ssd_scan": total["ssd_scan"]}
    for cls, part in inside.items():
        classes[cls] = part["gemm"] + part["elementwise"]
    for cls in ("gemm", "elementwise"):
        classes[cls] = total[cls] - sum(p[cls] for p in inside.values())
    busy = sum(total.values())
    top = sorted(names.items(), key=lambda kv: -kv[1])[:8]
    log(f"[train] profile of one bf16 step: wall_ms={wall:.1f} (under the "
        f"profiler) kernels={n} device_ms={busy:.1f} by class "
        f"{json.dumps({k: round(v, 3) for k, v in classes.items()})}; the "
        f"recompute's own flash/SSD kernels "
        f"{json.dumps({k: round(inside['recompute'][k], 3) for k in ('flash_fwd', 'ssd_scan')})} "
        f"(in their kernel classes); idle share against the unprofiled "
        f"step ({step_ms:.1f} ms) {max(0.0, 1 - busy / step_ms):.3f}; top "
        f"{json.dumps([(k[:60], round(v, 3)) for k, v in top])}")
    for cls, part in inside.items():
        if not sum(part.values()):
            log(f"[train] the profile linked no kernel to {cls}'s range: "
                f"its class reads 0 (not measured)")
    return dict(classes, device_ms=busy,
                idle_share=max(0.0, 1 - busy / step_ms))


def train_groups():
    """zamba2-7b's layer pattern cut to 13 layers: 13 SSD layers, 2
    shared-attention hits."""
    from repro_torch.configs.base import GroupSpec, LayerSpec
    ssd = LayerSpec(mixer="ssd", mlp="none")
    hit = LayerSpec(mixer="ssd", mlp="none", shared_attn=True)
    return (GroupSpec((ssd,) * 5 + (hit,), 2), GroupSpec((ssd,), 1))


def rel_l2(a, b):
    return float((a.double() - b.double()).norm()
                 / b.double().norm().clamp_min(1e-30))


def route_grads(torch, cfg, params, batch, device, use_pallas):
    """(loss, {path: grad}, seconds, launches) of one train step's
    gradient through the kernels (use_pallas) or the plain torch paths,
    the kernels' launches counted over this call alone."""
    from repro_torch.parallel.sharding import tree_leaves_with_path
    from repro_torch.training.train_state import loss_and_grads
    reset_model_launches()
    t0 = time.perf_counter()
    met, grads = loss_and_grads(cfg.replace(use_pallas=use_pallas), params,
                                batch)
    sync(torch, device)
    return (float(met["loss"]), dict(tree_leaves_with_path(grads)),
            time.perf_counter() - t0, model_launches())


def grad_errors(got, want):
    """Per-leaf relative L2 of ``got`` against ``want``, and over all
    leaves at once."""
    per = {p: rel_l2(g, want[p]) for p, g in got.items()}
    num = sum(float((g.double() - want[p].double()).norm()) ** 2
              for p, g in got.items())
    den = sum(float(w.double().norm()) ** 2 for w in want.values())
    return per, (num / max(den, 1e-300)) ** 0.5


def compare_routes(torch, cfg, params, batch, device):
    """One train step's loss and gradients through the kernels against
    the plain torch paths, from the same params and batch, in f32 and in
    bf16.  f32 (the CUDA-core kernels): loss within 1e-4 relative, every
    gradient leaf within 1e-3 relative L2.  bf16 (the tensor-core
    kernels): loss within 1e-2 relative.  The bf16 limit of 5e-2 relative
    L2 per gradient leaf is reported here over the whole model, and held
    block by block in `block_grads_check`: over 13 layers this random
    model's bf16 gradients drift from any other rounding of the same
    step by more than that, the reference's own bf16 against its f32
    included (PERF.md §6).  Neither route may give a leaf a zero gradient
    (the fault of a kernel launch that autograd cannot see through)."""
    n_ssd, n_attn = layer_counts(cfg)
    out = {}
    grads = {}
    for dtype in ("float32", "bfloat16"):
        c = cfg.replace(dtype=dtype)
        lk, gk, t_k, launched = route_grads(torch, c, params, batch, device,
                                            True)
        mma = dtype == "bfloat16"
        want = (route_counts(2 * n_attn, 2 * n_ssd, 2 * n_attn * mma,
                             2 * n_ssd * mma) if device == "cuda"
                else route_counts(0, 0, 0, 0))
        if launched != want:
            fail(f"the {dtype} train step launched {launched}, expected "
                 f"{want} (forward and recompute)")
        lp, gp, t_p, _ = route_grads(torch, c, params, batch, device, False)
        zero = sorted(p for p in gk if float(gk[p].norm()) == 0
                      or float(gp[p].norm()) == 0)
        per, total = grad_errors(gk, gp)
        worst = max(per, key=per.get)
        rec = {"loss_kernels": lk, "loss_plain": lp,
               "loss_rel": abs(lk - lp) / abs(lp), "worst_leaf": worst,
               "worst_rel_l2": per[worst], "all_leaves_rel_l2": total,
               "zero_grad_leaves": zero, "launches": launched,
               "grad_s_kernels": t_k, "grad_s_plain": t_p}
        log(f"[train] {dtype} kernels vs plain torch paths: loss {lk:.6f} "
            f"vs {lp:.6f} (rel {rec['loss_rel']:.3e}); worst grad leaf "
            f"{worst} rel L2 {per[worst]:.3e}, all leaves {total:.3e}, "
            f"{len(per)} leaves; zero-gradient leaves {zero}; launches "
            f"{json.dumps(launched)}; gradient {t_k:.2f}s with the kernels, "
            f"{t_p:.2f}s plain")
        if zero:
            fail(f"{dtype} train step: zero gradients for {zero}")
        if dtype == "float32":
            if not (rec["loss_rel"] <= 1e-4 and per[worst] <= 1e-3):
                fail(f"f32 train step: the kernels differ from the plain "
                     f"paths (loss {rec['loss_rel']:.3e} > 1e-4 or leaf "
                     f"{worst} {per[worst]:.3e} > 1e-3)")
            grads["f32"] = gp
        else:
            _, k_all = grad_errors(gk, grads["f32"])
            _, p_all = grad_errors(gp, grads["f32"])
            over = sorted(p for p in per if per[p] > 5e-2)
            rec.update(kernels_vs_f32=k_all, plain_vs_f32=p_all,
                       leaves_over_5e2=len(over))
            log(f"[train] bf16 whole model, kernels vs plain: the 5e-2 limit "
                f"per leaf is {'met' if not over else 'NOT MET'} ({len(over)} "
                f"of {len(per)} leaves over, worst {per[worst]:.3e}); "
                f"reported, held block by block below: bf16 rounding alone "
                f"moves each route this far from the f32 plain route over "
                f"all leaves: kernels {k_all:.3e}, plain {p_all:.3e}")
            if rec["loss_rel"] > 1e-2:
                fail(f"bf16 train step: loss {rec['loss_rel']:.3e} from the "
                     f"plain paths' (limit 1e-2)")
        out[dtype] = rec
        del gk, gp
    return out


def block_grads_check(torch, cfg, params, batch, device, tol=5e-2):
    """Each layer of the cut in bf16, on the same input through the kernels
    and through the plain torch paths: the input is the plain route's
    output of the layer before, the loss the layer's output against one
    fixed random probe.  Every gradient leaf (the layer's params, the
    shared attention's at a hit, the input) must lie within ``tol``
    relative L2 of the plain route's, and none may be zero.  The kernel
    route must launch `ssd_scan` once per layer and `flash_fwd` once per
    hit, on the tensor-core routes."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import tree_leaves_with_path
    c16 = cfg.replace(dtype="bfloat16")
    ck, cp = c16.replace(use_pallas=True), c16.replace(use_pallas=False)
    toks = batch["tokens"]
    B, S = toks.shape
    pos = torch.broadcast_to(torch.arange(S, device=toks.device), (B, S))
    aux = torch.zeros((), device=toks.device)
    gen = torch.Generator(device=toks.device)
    gen.manual_seed(23)

    def cast(a):
        return a.to(c16.act_dtype) if a.dtype == torch.float32 and \
            a.ndim >= 2 else a

    def graft(tree, leaves, pre):
        return {k: graft(v, leaves, f"{pre}{k}.") if isinstance(v, dict)
                else cast(leaves[f"{pre}{k}"]) for k, v in tree.items()}

    def layer_grads(c, ls, p, x, probe):
        shared = params["shared_attn"] if ls.shared_attn else None
        leaves = {"x": x.detach().requires_grad_()}
        for pre, tree in (("", p), ("shared_attn.", shared or {})):
            for path, a in tree_leaves_with_path(tree):
                leaves[pre + path] = a.detach().requires_grad_()
        with torch.enable_grad():
            y, _, _ = M.apply_layer(
                c, ls, graft(p, leaves, ""), leaves["x"], aux,
                shared_params=(graft(shared, leaves, "shared_attn.")
                               if shared else None),
                mode="train", positions=pos)
            gs = torch.autograd.grad((y.float() * probe).sum(),
                                     list(leaves.values()))
        return y.detach(), dict(zip(leaves, gs))

    worst, n_leaves, zero = ("", 0.0), 0, []
    per_layer = []
    reset_model_launches()
    with torch.no_grad():
        x = L.embed_tokens({"embedding": cast(params["embed"]["embedding"])},
                           toks, c16)
    for gi, g in enumerate(cfg.groups):
        gp = params["decoder"][f"g{gi}"]
        for r in range(g.repeat):
            ps = M._index_tree(gp, r)
            for li, ls in enumerate(g.layers):
                where = f"g{gi}.r{r}.L{li}"
                probe = torch.randn(x.shape, generator=gen,
                                    device=x.device)
                _, gk = layer_grads(ck, ls, ps[f"L{li}"], x, probe)
                x, gp_ = layer_grads(cp, ls, ps[f"L{li}"], x, probe)
                errs = {k: rel_l2(gk[k], gp_[k]) for k in gp_}
                zero += [f"{where}.{k}" for k in gp_
                         if float(gk[k].norm()) == 0
                         or float(gp_[k].norm()) == 0]
                top = max(errs, key=errs.get)
                per_layer.append((where, top, errs[top]))
                n_leaves += len(errs)
                if errs[top] > worst[1]:
                    worst = (f"{where}.{top}", errs[top])
                del gk, gp_
    launched = model_launches()
    n_ssd, n_attn = layer_counts(cfg)
    want = (route_counts(n_attn, n_ssd, n_attn, n_ssd) if device == "cuda"
            else route_counts(0, 0, 0, 0))
    over = [(w, k, e) for w, k, e in per_layer if e > tol]
    log(f"[train] bf16 block by block, kernels vs plain on the same input: "
        f"{n_leaves} gradient leaves over {len(per_layer)} layers, worst "
        f"{worst[0]} rel L2 {worst[1]:.3e} (limit {tol}); worst leaf per "
        f"layer {json.dumps([(w, k, round(e, 5)) for w, k, e in per_layer])}; "
        f"zero-gradient leaves {zero}; kernel-route launches "
        f"{json.dumps(launched)}")
    if launched != want:
        fail(f"the block check launched {launched}, expected {want}")
    if zero:
        fail(f"bf16 block check: zero gradients for {zero[:5]}")
    if over:
        fail(f"bf16 block check: layers whose worst leaf is over {tol}: "
             f"{over}")
    return {"worst_leaf": worst[0], "worst_rel_l2": worst[1],
            "leaves": n_leaves}


def train_step_phase(torch, cfg=None, device="cuda", B=2, S=2048, seed=17,
                     n_steps=3):
    """zamba2-7b at full width, cut to 13 layers (13 SSD layers, 2
    shared-attention hits): one train step's loss and gradients through
    the kernels against the plain torch paths in bf16 and in f32, then
    ``n_steps`` timed bf16 AdamW steps after one warm-up, with their
    launches, peak memory and a profile of one step by class.  (``cfg``
    and ``device`` let it be rehearsed small on the CPU.)"""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    from repro_torch.models.convert import params_from_reference
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.sharding import init_params_numpy
    from repro_torch.training.train_state import make_train_step
    cfg = (cfg or get_config("zamba2-7b").replace(groups=train_groups())
           ).replace(remat="full")
    specs = M.model_param_specs(cfg)
    n_params = M.count_params(cfg)
    n_ssd, n_attn = layer_counts(cfg)
    t0 = time.perf_counter()
    tree = init_params_numpy(seed, specs)
    params = params_from_reference(tree, specs, device=device)
    del tree
    condition_attention(cfg, params)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                         device=device, dtype=torch.int32)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    sync(torch, device)
    log(f"[train] zamba2-7b d_model {cfg.d_model}, {n_ssd} SSD layers, "
        f"{n_attn} shared-attention hits, {n_params} params (f32 masters, "
        f"shared attention scaled to a fan-in of d_model) drawn and loaded "
        f"in {time.perf_counter() - t0:.1f}s; B={B} S={S}, remat "
        f"{cfg.remat}, loss_chunk {cfg.loss_chunk}")
    routes = compare_routes(torch, cfg, params, batch, device)
    routes["blocks"] = block_grads_check(torch, cfg, params, batch, device)
    if device == "cuda":
        torch.cuda.empty_cache()

    # ---- the main path: timed AdamW steps -------------------------------- #
    c16 = cfg.replace(dtype="bfloat16", use_pallas=True)
    state = {"params": params,
             "opt": {k: _zeros_like(torch, params) for k in ("m", "v")},
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    step = make_train_step(c16, AdamWConfig())
    state, met = step(state, batch)                 # warm-up
    sync(torch, device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_model_launches()
    times, losses = [], [float(met["loss"])]
    for _ in range(n_steps):
        sync(torch, device)
        t0 = time.perf_counter()
        state, met = step(state, batch)
        sync(torch, device)
        times.append(time.perf_counter() - t0)
        losses.append(float(met["loss"]))
    launches = model_launches()
    want = (route_counts(2 * n_attn * n_steps, 2 * n_ssd * n_steps,
                         2 * n_attn * n_steps, 2 * n_ssd * n_steps)
            if device == "cuda" else route_counts(0, 0, 0, 0))
    if launches != want:
        fail(f"{n_steps} bf16 train steps launched {launches}, expected "
             f"{want}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"train losses not finite: {losses}")
    med = statistics.median(times)
    peak_gb = (torch.cuda.max_memory_allocated() / 2 ** 30
               if device == "cuda" else 0.0)
    flop = 8 * n_params * B * S
    log(f"[train] bf16 AdamW step: median {med:.4f}s over {n_steps} steps "
        f"(each {json.dumps([round(x, 4) for x in times])}) = "
        f"{B * S / med:.0f} tokens/s; model FLOP 8*N*T = {flop:.3e} "
        f"({flop / med / 1e12:.1f} TFLOP/s, {flop / med / BF16_OPS_PER_S:.3f} "
        f"of the bf16 dense peak); peak memory {peak_gb:.2f} GiB; losses "
        f"{json.dumps([round(x, 5) for x in losses])}; launches over the "
        f"{n_steps} steps {json.dumps(launches)}")
    classes = (profile_train_step(torch, lambda: step(state, batch),
                                  med * 1e3) if device == "cuda" else {})
    return {"step_s": med, "tokens_per_s": B * S / med, "peak_gib": peak_gb,
            "launches": launches, "per_step": {k: v // n_steps for k, v in
                                               launches.items()},
            "classes": classes, "routes": routes}


def _zeros_like(torch, tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(torch, v) for k, v in tree.items()}
    return torch.zeros_like(tree, dtype=torch.float32)


def trainer_phase(torch, cfg=None, device="cuda", seq=2048, batch=2,
                  steps=10, ckpt_every=5):
    """The `Trainer` loop on the card: run A trains ``steps`` steps and
    checkpoints every ``ckpt_every``; run B, a fresh Trainer, resumes from
    A's step-5 checkpoint and trains to ``steps``.  B's params must equal
    A's to 1e-6, B must lease only the pieces A did not train on, and
    the last step's swarm.json must verify against its image."""
    import shutil
    from repro_torch.checkpoint.swarm_restore import verify_image
    from repro_torch.configs.base import get_config, reduced_config
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.sharding import tree_leaves_with_path
    from repro_torch.training.trainer import Trainer, TrainerConfig
    # the reduced widths at d_model 512, with the full config's chunking
    # (the reduced 16-row chunks would walk 128 SSD chunks and ~4,000
    # attention bricks in Python at S=2048)
    cfg = cfg or reduced_config(get_config("zamba2-7b")).replace(
        d_model=512, use_pallas=True, remat="full", attn_chunk_q=1024,
        attn_chunk_kv=1024, ssd_chunk=256)
    root = ROOT / "build" / "chip_trainer"
    shutil.rmtree(root, ignore_errors=True)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=steps)

    def trainer(d, n):
        return Trainer(cfg, opt, TrainerConfig(
            batch=batch, seq=seq, steps=n, ckpt_every=ckpt_every,
            ckpt_dir=str(root / d), log_every=0), device=device)

    reset_model_launches()
    t0 = time.perf_counter()
    a = trainer("a", steps)
    a.init(seed=5)
    hist_a = a.run()
    wall_a = time.perf_counter() - t0
    launched = model_launches()
    if device == "cuda" and not (launched["flash_fwd"] > 0
                                 and launched["ssd_scan"] > 0):
        fail(f"the Trainer's steps launched {launched}")
    os.makedirs(root / "b")
    shutil.copytree(a.store.step_dir(ckpt_every),
                    root / "b" / f"step_{ckpt_every:08d}")
    b = trainer("b", steps)
    b.init(seed=123)                    # the seed is unused on resume
    if int(b.state["step"]) != ckpt_every or \
            b.pipeline.state.next_piece != ckpt_every:
        fail(f"run B resumed at step {int(b.state['step'])}, piece "
             f"{b.pipeline.state.next_piece}")
    hist_b = b.run()
    leased = sorted(it.payload["piece"] for it in b.coord.items.values())
    if leased != list(range(ckpt_every, steps)):
        fail(f"run B leased pieces {leased}: a batch was replayed or "
             "skipped")
    got = dict(tree_leaves_with_path(b.state["params"]))
    worst = max(float((x.float() - got[p].float()).abs().max())
                for p, x in tree_leaves_with_path(a.state["params"]))
    pm = a.store.swarm_manifest(steps)
    ok_swarm = verify_image(a.store.pack_image(steps), pm)
    prev = a.store.swarm_manifest(ckpt_every)
    log(f"[trainer] reduced zamba2 d_model {cfg.d_model} {cfg.dtype}, "
        f"B={batch} S={seq}: run A {steps} steps in {wall_a:.2f}s (w_s "
        f"{json.dumps([round(h['w_s'], 4) for h in hist_a])}), losses "
        f"{json.dumps([round(h['loss'], 5) for h in hist_a])}; run B resumed "
        f"at step {ckpt_every} and leased pieces {leased}, losses "
        f"{json.dumps([round(h['loss'], 5) for h in hist_b])}; B vs A params "
        f"max abs diff {worst:.3e} (limit 1e-6); swarm.json of step {steps} "
        f"verifies {ok_swarm} (version {pm.version}, chained to step "
        f"{ckpt_every}'s {pm.prev_manifest_hash == prev.manifest_hash}); "
        f"kernel launches {json.dumps(launched)}")
    if worst > 1e-6:
        fail(f"the resumed run differs from the straight run by {worst:.3e}")
    if not ok_swarm or pm.prev_manifest_hash != prev.manifest_hash:
        fail("the trainer's swarm.json does not verify")
    shutil.rmtree(root, ignore_errors=True)


def swarm_restore_phase(torch, cfg=None, want=None, device="cuda",
                        n_replicas=2):
    """The 7-layer f32 zamba2 of `serve_reference_phase` (same groups,
    seed and weights) saved by `CheckpointStore` (4 MB swarm pieces),
    fetched by replicas from the origin through the scalar protocol, and
    cold-started on the card with `ServingEngine.from_swarm`: the restored
    leaves must equal the saved ones bit for bit, and the engine's greedy
    tokens must be `reference_serve.json`'s.  A replica without the whole
    piece set is refused.  (A small rehearsal on the CPU passes its own
    ``cfg`` and the tokens ``want`` that it expects after
    reference_serve.json's prompt.)"""
    import shutil
    import numpy as np
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.checkpoint.swarm_restore import checkpoint_application
    from repro_torch.core import (Agent, AgentConfig, LinkModel, SimRuntime,
                                  TrackerConfig, TrackerServer)
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import (init_params_numpy,
                                               tree_leaves_with_path)
    from repro_torch.serving.engine import ServeConfig, ServingEngine
    ref = json.loads(SERVE_FILE.read_text())
    cfg = cfg or serve_reference_config(ref)
    want = want or [s["token"] for s in ref["steps"]]
    specs = M.model_param_specs(cfg)
    root = ROOT / "build" / "chip_swarm"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    tree = init_params_numpy(ref["seed"], specs)
    draw_s = time.perf_counter() - t0
    store = CheckpointStore(str(root / "origin"))
    t0 = time.perf_counter()
    store.save(0, tree, extra={"arch": ref["arch"], "seed": ref["seed"]})
    save_s = time.perf_counter() - t0
    app = checkpoint_application(store, host_id="origin")
    rt = SimRuntime(link=LinkModel(uplink_Bps=1.25e9, downlink_Bps=1.25e9))
    rt.add_node(TrackerServer(config=TrackerConfig(ping_interval_s=1.0)))
    acfg = dict(work_timeout_s=60.0, status_interval_s=0.5,
                piece_timeout_s=3.0, replicate_completed=True)
    origin = Agent("origin", config=AgentConfig(**acfg))
    rt.add_node(origin)
    origin.host_app(app)
    replicas = [Agent(f"R{i}", config=AgentConfig(**acfg))
                for i in range(n_replicas)]
    for r in replicas:
        rt.add_node(r)
    t0 = time.perf_counter()
    rt.run(until=3600, stop_when=lambda: all(app.app_id in r.images
                                             for r in replicas))
    fetch_s = time.perf_counter() - t0
    if not all(app.app_id in r.images for r in replicas):
        fail("the replicas did not complete the checkpoint's piece set")
    prompt = np.asarray(ref["prompt"], np.int32)
    sc = ServeConfig(slots=1, max_len=len(prompt) + len(want) + 1)
    try:
        ServingEngine.from_swarm(cfg, specs, sc, agent=Agent("late"),
                                 app_id=app.app_id, device=device)
        fail("a replica without the piece set was not refused")
    except RuntimeError as e:
        if "ready gate" not in str(e):
            raise
    t0 = time.perf_counter()
    eng = ServingEngine.from_swarm(cfg, specs, sc, agent=replicas[0],
                                   app_id=app.app_id,
                                   workdir=str(root / "R0"), device=device)
    sync(torch, device)
    restore_s = time.perf_counter() - t0
    got = dict(tree_leaves_with_path(eng.params))
    for path, a in tree_leaves_with_path(tree):
        x = got[path]
        if x.device.type != device or not np.array_equal(x.cpu().numpy(), a):
            fail(f"restored leaf {path} differs from the saved one")
    del tree
    eng.submit(prompt, max_new=len(want))
    (req,) = list(eng.queue)
    t0 = time.perf_counter()
    while eng.queue or eng.active:
        eng.step()
    sync(torch, device)
    serve_s = time.perf_counter() - t0
    log(f"[swarm-restore] {ref['arch']} {len(cfg.groups)} groups, "
        f"{M.count_params(cfg)} f32 params: weights drawn in {draw_s:.1f}s; "
        f"save {save_s:.2f}s ({app.app_bytes} image bytes, "
        f"{app.manifest.n_pieces} pieces of {app.manifest.piece_bytes}); "
        f"fetch by {n_replicas} replicas {rt.now():.3f} virtual s, "
        f"{fetch_s:.2f} wall s, origin egress {rt.tx_bytes.get('origin', 0)} "
        f"bytes; from_swarm restore {restore_s:.2f}s on {device}, every "
        f"leaf equal to the saved one; served {len(prompt)} prompt tokens + "
        f"{len(want)} in {serve_s:.2f}s: tokens {req.out_tokens} "
        f"(expected {want}); a replica without the piece set refused")
    if req.out_tokens != want:
        fail("the engine cold-started from the swarm gives other tokens")
    shutil.rmtree(root, ignore_errors=True)


def main():
    if os.environ.get("PYTHONHASHSEED") != "0":
        env = dict(os.environ, PYTHONHASHSEED="0")
        os.execve(sys.executable,
                  [sys.executable, str(Path(__file__).resolve()),
                   *sys.argv[1:]], env)
    if not (SRC / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}")
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        fail("torch finds no CUDA device")
    from repro_torch import kernels_build, scenarios
    from repro_torch.core import swarm_kernels as sk
    kind = torch.cuda.get_device_name(0)
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {kind} "
        f"count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    kernels_build.load()
    info = kernels_build.BUILD_INFO
    log(f"[build] {info['path']} in {time.perf_counter() - t0:.2f}s "
        f"(nvcc {info['seconds']:.2f}s)")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[build] {line.strip()}")

    records = kernel_phase(torch, sk)

    sk.reset_launches()
    t0 = time.perf_counter()
    end_to_end_phase(torch, sk, scenarios)
    log(f"[time] swarm end-to-end phase {time.perf_counter() - t0:.1f}s")
    launches = dict(sk.LAUNCHES)
    missing = [k for k in SWARM_KERNELS if launches[k] <= 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    pump_launches("main path", launches)

    # ---- serve slice ----------------------------------------------------- #
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    records.update(model_kernel_phase(torch))
    log(f"[time] serve-slice kernel phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    serve_reference_phase(torch)
    torch.cuda.empty_cache()
    log(f"[time] reference phase {time.perf_counter() - t0:.1f}s")
    serve_launches = serve_full_phases(torch)
    missing = [k for k, v in serve_launches.items() if v <= 0]
    if missing:
        fail(f"kernels never launched on the serve path: {missing}")
    launches.update(serve_launches)

    # ---- train slice ----------------------------------------------------- #
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train = train_step_phase(torch)
    log(f"[time] train-step phase {time.perf_counter() - t0:.1f}s")
    missing = [k for k in ("flash_fwd", "ssd_scan") if train["launches"][k]
               <= 0]
    if missing:
        fail(f"kernels never launched on the train path: {missing}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    trainer_phase(torch)
    log(f"[time] trainer phase {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    swarm_restore_phase(torch)
    log(f"[time] swarm-restore phase {time.perf_counter() - t0:.1f}s")

    kernels = []
    for name in ("rarest_keys", "island_has", "match_requests", "flash_fwd",
                 "ssd_scan"):
        rec = [r for r in records[name] if "ms" in r][0]
        kernel = KERNEL_OF_ROW.get(name, name)
        kernels.append({
            "name": name, "route": "cuda", "kernel_route": ROUTES[name],
            "kernel": kernel, "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[kernel],
            "max_abs_err": max(r["max_abs_err"] for r in records[name]),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], "v1_ms": rec.get("v1_ms"),
            "route_launches": {k: v for k, v in launches.items()
                               if k.startswith(name + ".")
                               or (k == name and k != kernel)},
            # the train path: the timed bf16 steps (forward + recompute)
            "train_launches": train["launches"].get(kernel, 0),
            "train_launches_per_step": train["per_step"].get(kernel, 0)})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
