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
   - Scenario VIII at N=24 batched (fault-free and chaos arms: loss,
     duplication, jitter, 30% churn with restarts, a partition), each
     arm's invariants checked on the card, device planes included;
   - one `ChaosScenario` at N=200 on 8 ISP islands with an island cut
     off (the P4P arm under faults), its invariants checked;
   - Scenario X at N=24 (80 pieces: v1 crowd, v2 delta, scratch
     re-fetch, and the scalar chaos overlay on 12 volunteers), which
     must upgrade every volunteer with no stale piece accepted;
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
   flash in f16 too, an f16 scan whose M passes f16's range, on the
   CUDA cores, and the scan's wgmma edges: two rounds of its cluster,
   S = 1, G = 2, P = N = 128, and a misaligned x on mma.sync), times the
   wgmma kernels against their mma.sync kernels in turns (v2, v3, v3,
   v2): the scan at the four main-path shapes (zamba2's prefill, the
   train step, a (2, 2) serve and train rank), flash at its six beside
   `scaled_dot_product_attention`; runs
   zamba2-7b at full width cut to 7 layers in f32 against
   `src/repro_torch/reference_serve.json` (the reference package's
   prefill and decode logits); drives zamba2-7b at full depth and width in
   bf16 (B=4, S=2048 prefill, 32 decode steps) through `make_prefill_step`
   / `make_decode_step`, checks that each prefill launched `ssd_scan` 81
   and `flash_fwd` 13 times, all on the tensor-core routes (`.wgmma`
   for both: by the wrappers' counts and by the kernel names in a
   profiler trace), and
   holds its logits to the plain torch
   paths; serves 4 requests through `ServingEngine` on the f32 model and
   holds each to a full-forward greedy decode;
4. train slice: zamba2-7b at full width cut to 13 layers (13 SSD layers,
   2 shared-attention hits; f32 masters, B=2, S=2048, remat "full"):
   one train step's loss and gradients through the kernels against the
   plain torch paths in f32 and in bf16 (`compare_routes`), with
   `ssd_scan` launched 26 and `flash_fwd` 4 times (forward and
   recompute; all `.wgmma` in bf16) and no zero-gradient leaf;
   each layer's
   bf16 gradients on the same input through both routes
   (`block_grads_check`); the f32 step under remat "dots" against
   "full" (`dots_check`: equal, or within 1e-5); three timed bf16 AdamW
   steps (tokens/s, peak memory) and a profile of one by class, under
   remat "full" and then "dots" (the device ms under the recompute
   range beside each other); the `Trainer` on a reduced zamba2 (d_model
   512, S=2048, the kernels) resumed from its step-5 checkpoint, equal
   to the straight run; the examples `examples/port_serve_lm.py` and
   `examples/port_train_lm.py --size tiny --steps 10` as child
   processes on the card (`examples_phase`); the 7-layer f32 zamba2
   saved by `CheckpointStore`, fetched by two replicas through the
   scalar protocol, and cold-started on the card by
   `ServingEngine.from_swarm`, bit-equal leaves and
   `reference_serve.json`'s tokens;
5. MoE and encoder-decoder slice: `flash_fwd` at qwen3-moe's shape (GQA
   32:4, D=128, causal) and seamless's encoder shape (16 heads, D=64, no
   mask), bf16 on `.wgmma`, against its plain version, timed beside
   `scaled_dot_product_attention` (in step 3's kernel phase);
   qwen3-moe-30b-a3b at full width cut to 2 layers in f32 against
   `src/repro_torch/reference_serve_moe.json` (tokens, logits, and each
   MoE call's expert counts and capacity drops), and its `ServingEngine`
   against a full-forward greedy decode; qwen3-moe-30b-a3b at full width
   and depth (48 layers, 30.5e9 params) in bf16, B=4 S=2048 prefill and 32
   decode steps with 48 `.wgmma` flash launches a prefill, a profile by
   class (expert GEMMs, dispatch and combine glue, attention projections,
   `flash_fwd`, elementwise), the idle share, the host syncs of a decode
   step, and every layer through both routes; seamless-m4t-medium whole
   in f32 against `src/repro_torch/reference_serve_encdec.json` (1280
   encoder frames, 320 target tokens, 8 steps), then in bf16 (B=4, 2048
   frames, 512 target tokens, 32 steps) with the same measurements;
6. the paper's experiments and the torrent ring across ranks: Tables I
   and IV (six volunteers) and Scenarios V, VI and XI (R=8, 256 MB) on
   the scalar protocol against `reference_runs.json`, with each run's
   wall seconds on the host (host work only: a child process runs them
   beside the kernel build and the kernel phase of step 2, and its lines
   print after that phase); then 4 spawned ranks on one gloo
   `DeviceMesh` with axis ("pod",): rank 0 fetches the 7-layer f32
   zamba2 checkpoint (789 swarm pieces of 4 MB) through the scalar
   protocol, all 4 cold-start with `ServingEngine.from_swarm(...,
   mesh=)` on the card (ranks 1-3 over the ring), every rank's leaves
   bit-equal to the saved ones (digests gathered) and its greedy tokens
   `reference_serve.json`'s; `restore_distributed` straight from the
   store on the same mesh; `pipeline_apply` at the reference check's
   shapes on the card; prints the ring's seconds, each rank's bytes
   sent and the seeder's upload as a multiple of the image.  With two
   cards or more the ring also runs on NCCL;
7. the mesh slice (`mesh_serve_phase`): 4 spawned gloo ranks sharing
   the card as a (data, model) mesh (the collectives cross the host, the
   compute and the kernels stay on the card): `flash_fwd` and `ssd_scan`
   at a rank's local-head shapes against their plain versions; zamba2-7b
   at full width cut to 13 layers in bf16 (B=4 S=2048, 16 decode steps)
   on (2, 2), each layer within 2e-2 of the single-device layer on the
   same input; the 7-layer f32 zamba2 of `reference_serve.json` on (2, 2)
   and (1, 4) and the sharded `ServingEngine` against the single-device
   engine; qwen3-moe-30b-a3b at full width cut to 4 layers in bf16 (a2a
   prefill, 2 replicated decode steps); the 2-layer f32 qwen3-moe against
   `src/repro_torch/reference_serve_mesh.json` (tokens, logits, every
   shard's expert counts and drops).  With two cards or more the f32
   zamba2 also runs on a (1, 2) NCCL mesh.  `python3 chip_smoke.py
   --mesh-serve` builds the kernels and runs this phase alone;
8. training over the same (2, 2) mesh under `DEFAULT_RULES`
   (`mesh_train_phase`): FSDP over data, TP and the sequence-split
   residual over model.  In this process, one device: the 7-layer f32
   zamba2's step (kept on the host) and qwen3-moe-30b-a3b at full width
   cut to 4 layers, bf16 with f32 masters, B=2 S=2048 (each layer's
   gradients through the kernels within 5e-2 of the plain route's, the
   routing pinned; timed steps, expert counts and drops, a profile by
   class).  Then 4 gloo ranks on the card: `flash_fwd` and `ssd_scan`
   at a train rank's local shapes against their plain versions; the
   7-layer f32 zamba2 step on the mesh within 1e-4 (loss), 1e-3
   (each gradient leaf, relative L2) and 5e-4 (params) of one device's,
   and its gradients under remat "dots" against its own under "full";
   the 13-layer bf16 zamba2, each layer's gradients within 5e-2 of one
   device's on the same input and probe, then a warm-up and 2 timed
   steps with their wire and host-hop bytes, s in collectives, peak
   memory and launches; the 2-layer f32 qwen3-moe with the exact and
   the int8 all-to-all (loss within 5e-2, each gradient leaf within
   0.25 relative L2 of the exact one's, every gradient finite).
   `python3 chip_smoke.py --mesh-train` builds the kernels and runs
   this phase alone;
9. prints the per-kernel JSON line (each row with its launches on the
   serve, MoE, enc-dec, train (remat "full" and "dots"), mesh serve and
   mesh train paths), the
   card's name and power limit, and as the last line `{"ok": true,
   "device": {...}}`.

Any failure exits non-zero without the last line.  The protocol iterates
sets of node names, so the script re-executes itself under
PYTHONHASHSEED=0, the seed the expected values were taken under.
"""
import contextlib
import functools
import json
import math
import os
import statistics
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
RUNS_FILE = SRC / "repro_torch" / "reference_runs.json"
# the entries of reference_runs.json driven on the card, in order
# VIII and X at N=24 ("viii_n24_batched", "x_n24_p80": 80 pieces, so
# still the sort route and the matcher's wide route): at N=200 they took
# 47-81 s and 27-36 s of host-bound event drain, and the whole script
# neared its time limit once the mesh train phase joined it
CHIP_RUNS = ("vii_n2000", "ix_n500_i8", "viii_n24_batched",
             "chaos_n200_i8_batched", "x_n24_p80")
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
    "flash_fwd": "src/repro_torch/csrc/flash_fwd_wgmma.cu",
    "ssd_scan": "src/repro_torch/csrc/ssd_scan_wgmma.cu",
}
# the route each kernel of the line ran on its main path: bf16 serving
# and training take the tensor-core kernels (flash and the SSD scan on
# wgmma and TMA, the scan's state chained across a thread-block cluster),
# the P4P cost rows one thread-block cluster
ROUTES = {"rarest_keys": "cuda", "island_has": "cuda-cluster",
          "match_requests": "cuda", "flash_fwd": "cuda-wgmma",
          "ssd_scan": "cuda-wgmma"}
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


# where `main` keeps every line `log` prints (build/chip_smoke.log: a
# reader of the output may get only its tail)
LOG_FILE = None


def log(msg):
    print(msg, flush=True)
    if LOG_FILE is not None:
        with open(LOG_FILE, "a") as f:
            print(msg, file=f)


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
def model_kernel_phase(torch):
    """`flash_fwd` and `ssd_scan` against their plain versions on CUDA
    tensors: the reference's kernel-test cases, then the main paths'
    shapes (timed; the kernels line reports each kernel's first timed
    record).
    Their bounds count the work the package's FLOP formulas count
    (`live_pairs`, `ssd_ops`: what a meta trace of a step counts)."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.kernel import live_pairs
    from repro_torch.kernels.ssd import kernel as ssk
    from repro_torch.kernels.ssd.kernel import ssd_ops
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
            f"(tolerance {tol:.3g}{' of max ' + f'{scale:.3f}' if relative else ''})")

    def timed(name, kernel, prev, plain, n_bytes, n_ops, peak, library=None,
              turn=("v2", "v3")):
        """Device ms of the kernel and of the version it replaced,
        ``prev`` (flash's and the scan's mma.sync v2; named by ``turn``), in
        turns (prev, kernel, kernel, prev), each the mean of its two turns
        (the kernel alone, twice, where ``prev`` is None)."""
        turns = [device_ms(f, reps=10, inner=3)
                 for f in ((kernel,) * 2 if prev is None
                           else (prev, kernel, kernel, prev))]
        if prev is None:
            ms, prev_ms = sum(turns) / 2, None
        else:
            ms = (turns[1] + turns[2]) / 2
            prev_ms = (turns[0] + turns[3]) / 2
        ms_call = call_ms(kernel, reps=10)
        plain_ms = call_ms(plain, reps=5)
        lib_ms = device_ms(library, reps=10, inner=3) if library else None
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_ops / peak * 1e3
        b_ms, b_by = ((t_bytes, "bytes") if t_bytes >= t_ops
                      else (t_ops, "operations"))
        rec = records[name][-1]
        rec.update({"ms": ms, f"{turn[0]}_ms": prev_ms, "call_ms": ms_call,
                    "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": lib_ms, "bytes": n_bytes, "ops": n_ops})
        order = (f"{turn[1]} {turn[1]}" if prev is None else
                 f"{turn[0]} {turn[1]} {turn[1]} {turn[0]}")
        log(f"[kernel] {name} {rec['case']}: ms={ms:.4f} (turns {order} "
            f"{' '.join(f'{x:.4f}' for x in turns)}; one call as issued "
            f"{ms_call:.4f}) {turn[0]}_ms={prev_ms} plain_ms={plain_ms:.3f} "
            f"bytes={n_bytes} "
            f"ops={n_ops} bound_ms={b_ms:.4f} ({b_by})"
            + (f" library_ms={lib_ms:.4f}" if lib_ms is not None else ""))

    def took_route(n0, route, case):
        """Fail unless the one launch since ``n0`` took ``route``."""
        got = {k: fk.LAUNCHES[k] - n0[k] for k in fk.LAUNCHES}
        want = {"flash_fwd": 1, "flash_fwd.wgmma": int(route == "wgmma"),
                "flash_fwd.mma": int(route == "mma")}
        if got != want:
            fail(f"flash_fwd [{case}] launched {got}, expected the "
                 f"{route} route")

    # ---- flash_fwd ------------------------------------------------------ #
    # the reference's kernel-test cases: f32 on the CUDA cores, bf16 and
    # f16 on wgmma (head dims 16 to 64, multiples of 8)
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2),
                       (torch.float16, 2e-2)):
        for B, Sq, Skv, Hq, Hkv, D, causal, window in FLASH_CASES:
            q, k, v = (up(s, dtype) for s in ((B, Sq, Hq, D),
                                              (B, Skv, Hkv, D),
                                              (B, Skv, Hkv, D)))
            case = f"{(B, Sq, Skv, Hq, Hkv, D, causal, window)} {dtype}"
            n0 = dict(fk.LAUNCHES)
            out, lse = fk.flash_fwd(q, k, v, causal=causal, window=window)
            took_route(n0, "v1" if dtype == torch.float32 else "wgmma",
                       case)
            want, wlse = fk.flash_fwd_plain(q, k, v, causal=causal,
                                            window=window)
            check("flash_fwd", case, out, want, tol, "out")
            check("flash_fwd", case, lse, wlse,
                  1e-4 if dtype == torch.float32 else 2e-2, "lse")
    # the main paths' shapes at S=2048, each on wgmma against its plain
    # version and timed in turns against mma.sync beside SDPA (the first
    # is the one the kernels line reports): zamba2's prefill (32 heads,
    # D=112, causal), qwen3-moe's decoder (GQA 32:4, D=128, causal),
    # seamless's encoder (16 heads, D=64, no mask), a (2, 2) serve mesh
    # rank's local heads of zamba2 and of qwen3-moe, and a (2, 2) train
    # rank's of zamba2; the 13-layer zamba2 train step's (B=2) is checked
    # and not timed.  Out within 2e-2, and within 1e-2 of max |want|
    # where |out| is small (one bf16 ulp of the largest value is 2^-7 =
    # 7.8e-3 of it; |out| is ~0.04 without a mask over 2048 keys).
    S = 2048
    for B, Hq, Hkv, D, causal, what, timed_here in (
            (4, 32, 32, 112, True, "zamba2 prefill", True),
            (2, 32, 32, 112, True, "train step", False),
            (4, 32, 4, 128, True, "qwen3-moe", True),
            (4, 16, 16, 64, False, "seamless enc", True),
            (2, 16, 16, 112, True, "zamba2, a mesh rank", True),
            (2, 16, 2, 128, True, "qwen3-moe, a mesh rank", True),
            (1, 16, 16, 112, True, "zamba2, a mesh train rank", True)):
        q = up((B, S, Hq, D), torch.bfloat16)
        k, v = (up((B, S, Hkv, D), torch.bfloat16) for _ in range(2))
        case = (f"B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} "
                f"{'causal' if causal else 'bidirectional'} bf16 ({what})")
        n0 = dict(fk.LAUNCHES)
        out, lse = fk.flash_fwd(q, k, v, causal=causal)
        took_route(n0, "wgmma", case)
        want, wlse = fk.flash_fwd_plain(q, k, v, causal=causal)
        check("flash_fwd", case, out, want,
              min(2e-2, 1e-2 * float(want.float().abs().max()))
              if what in ("qwen3-moe", "seamless enc") else 2e-2, "out")
        check("flash_fwd", case, lse, wlse, 2e-2, "lse")
        if timed_here:
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            timed("flash_fwd",
                  lambda: fk.flash_fwd(q, k, v, causal=causal),
                  lambda: fk.flash_fwd_v2(q, k, v, causal=causal),
                  lambda: fk.flash_fwd_plain(q, k, v, causal=causal),
                  nbytes(q, k, v, out) + lse.numel() * 4,
                  4 * B * Hq * D * live_pairs(S, S, causal, 0),
                  BF16_OPS_PER_S,
                  library=lambda: F.scaled_dot_product_attention(
                      qt, kt, vt, is_causal=causal, enable_gqa=Hq != Hkv),
                  turn=("v2", "v3"))
            del qt, kt, vt
        del q, k, v, out, lse, want, wlse

    # ---- ssd_scan -------------------------------------------------------- #
    def ssd_inputs(B, S, H, P, G, N, dtype, offset=0):
        """x (``offset`` elements into its allocation), dt, A, B, C."""
        x = up((B, S, H, P), dtype)
        if offset:
            x = torch.empty(x.numel() + offset, dtype=dtype, device="cuda")[
                offset:].view(x.shape).copy_(x)
        dt = torch.nn.functional.softplus(up((B, S, H), torch.float32))
        A = -torch.exp(up((H,), torch.float32, 0.3))
        return (x, dt.contiguous(), A.contiguous(),
                up((B, S, G, N), dtype, 0.5), up((B, S, G, N), dtype, 0.5))

    def took_ssd_route(n0, route, case):
        """Fail unless the one launch since ``n0`` took ``route``."""
        got = {k: ssk.LAUNCHES[k] - n0[k] for k in ssk.LAUNCHES}
        want = {"ssd_scan": 1, "ssd_scan.wgmma": int(route == "wgmma"),
                "ssd_scan.mma": int(route == "mma")}
        if got != want:
            fail(f"ssd_scan [{case}] launched {got}, expected the {route} "
                 "route")

    def ssd_case(B, S, H, P, G, N, chunk, dtype, route, case, tol,
                 offset=0, relative=True):
        args = ssd_inputs(B, S, H, P, G, N, dtype, offset)
        n0 = dict(ssk.LAUNCHES)
        y, fin = ssk.ssd_scan(*args, chunk=chunk)
        took_ssd_route(n0, route, case)
        wy, wfin = ssk.ssd_scan_plain(*args, chunk=chunk)
        check("ssd_scan", case, y, wy, tol, "y", relative=relative)
        check("ssd_scan", case, fin, wfin, tol, "state", relative=relative)
        return args, y, fin

    for B, S, H, P, G, N, chunk in SSD_CASES:
        ssd_case(B, S, H, P, G, N, chunk, torch.float32, "v1",
                 f"{(B, S, H, P, G, N, chunk)} f32", 1e-3, relative=False)
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
    case = f"{(B, S, H, P, 1, N, chunk)} f16, |M| > 65504"
    took_ssd_route(n0, "v1", case)
    wy, wfin = ssk.ssd_scan_plain(*args, chunk=chunk)
    check("ssd_scan", case, y, wy, 1e-2, "y", relative=True)
    check("ssd_scan", case, fin, wfin, 1e-2, "state", relative=True)
    # bf16 edges of the wgmma kernel: two rounds of its cluster (S = 4096),
    # S = 1, G = 2 on 5 chunks (3 spare slots), P = N = 128; then an x
    # 2 bytes off 16, which a tensor map refuses: mma.sync
    for B, S, H, P, G, N, chunk, route, what in (
            (1, 4096, 4, 64, 1, 64, 256, "wgmma", "two rounds"),
            (1, 1, 2, 64, 1, 64, 256, "wgmma", "S = 1"),
            (2, 320, 4, 32, 2, 16, 64, "wgmma", "G = 2, 5 chunks"),
            (1, 300, 2, 128, 1, 128, 128, "wgmma", "P = N = 128"),
            (2, 300, 4, 64, 1, 64, 256, "mma", "x off 16 bytes")):
        ssd_case(B, S, H, P, G, N, chunk, torch.bfloat16, route,
                 f"{(B, S, H, P, G, N, chunk)} bf16 ({what})", 1e-2,
                 offset=int(route == "mma"))
    # the main paths' shapes, each on wgmma against its plain version and
    # timed in turns against mma.sync (`ssd_scan_v2`; the first is the one
    # the kernels line reports): zamba2's prefill, the 13-layer train
    # step (B=2), a (2, 2) serve rank (B=4 over data, 112 SSM heads over
    # model) and a (2, 2) train rank (B=2 over data)
    S, P, G, N, chunk = 2048, 64, 1, 64, 256
    for B, H, what in ((4, 112, ""), (2, 112, " (train)"),
                       (2, 56, " (a mesh rank)"),
                       (1, 56, " (a mesh train rank)")):
        case = f"B={B} S={S} H={H} P={P} G={G} N={N} chunk={chunk} bf16{what}"
        args, y, fin = ssd_case(B, S, H, P, G, N, chunk, torch.bfloat16,
                                "wgmma", case, 1e-2)
        timed("ssd_scan",
              lambda: ssk.ssd_scan(*args, chunk=chunk),
              lambda: ssk.ssd_scan_v2(*args, chunk=chunk),
              lambda: ssk.ssd_scan_plain(*args, chunk=chunk),
              sum(t.numel() * t.element_size() for t in (*args, y, fin)),
              ssd_ops(B, S, H, P, N, chunk), BF16_OPS_PER_S,
              turn=("v2", "v3"))
        del args, y, fin
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


def route_counts(n_flash, n_ssd, n_flash_tc, n_ssd_tc):
    """The launch counts a run should show: ``n_flash_tc`` of the flash
    launches and ``n_ssd_tc`` of the scan's on the tensor cores, which on
    every main path is the wgmma route (bf16 flash at head dims 64, 112
    and 128, the bf16 scan at P = N = 64, chunk 256), none on mma.sync."""
    return {"flash_fwd": n_flash, "flash_fwd.wgmma": n_flash_tc,
            "flash_fwd.mma": 0, "ssd_scan": n_ssd,
            "ssd_scan.wgmma": n_ssd_tc, "ssd_scan.mma": 0}


def layer_counts(cfg):
    n_ssd = sum(g.repeat * sum(ls.mixer == "ssd" for ls in g.layers)
                for g in cfg.groups)
    n_attn = sum(g.repeat * sum(ls.shared_attn for ls in g.layers)
                 for g in cfg.groups)
    return n_ssd, n_attn


def serve_reference_config(ref):
    """The model a `reference_serve*.json` was taken on: its architecture
    at full width, cut to its groups (when it names any), in its dtype,
    with the kernels."""
    from repro_torch.configs.base import GroupSpec, LayerSpec, get_config
    cfg = get_config(ref["arch"]).replace(dtype=ref["dtype"],
                                          use_pallas=True)
    if ref["groups"] is None:
        return cfg
    return cfg.replace(groups=tuple(
        GroupSpec(tuple(LayerSpec(*ls) for ls in layers), r)
        for layers, r in ref["groups"]))


@functools.lru_cache(maxsize=1)
def reference_tree(seed, cfg):
    """The numpy weights of ``cfg`` drawn from ``seed`` as the reference's
    writers drew them, kept for the next caller of the same pair (the
    serve-reference and swarm-restore phases share the 7-layer zamba2's,
    ~15 s of drawing on the host).  Read only: the tensors made from it
    are copies."""
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import init_params_numpy
    return init_params_numpy(seed, M.model_param_specs(cfg))


def reference_params(torch, ref, cfg, device):
    """The weights of ``ref["seed"]`` drawn with numpy as the reference's
    writer drew them (each leaf's sum of |w| checked against the file),
    on ``device``, with the attention scaled as the writer scaled it where
    the file says ``attention_scaled``."""
    import numpy as np
    from repro_torch.models import model as M
    from repro_torch.models.convert import params_from_reference
    from repro_torch.parallel.sharding import tree_leaves_with_path
    specs = M.model_param_specs(cfg)
    t0 = time.perf_counter()
    tree = reference_tree(ref["seed"], cfg)
    for path, a in tree_leaves_with_path(tree):
        want = ref["weight_abs_sums"].get(path)
        if want is not None and abs(float(np.sum(np.abs(a),
                                                 dtype=np.float64))
                                    - want) > 1e-9 * want:
            fail(f"weights drawn here differ from the reference's: {path}")
    params = params_from_reference(tree, specs, device=device)
    del tree
    if ref.get("attention_scaled"):
        condition_attention(params)
    log(f"[serve-ref] {ref['arch']}: {M.count_params(cfg)} params drawn "
        f"and loaded in {time.perf_counter() - t0:.1f}s"
        f"{' (attention scaled)' if ref.get('attention_scaled') else ''}")
    return params


def reference_steps_check(torch, ref, cfg, params, batch, src_len, device,
                          what):
    """Prefill ``batch`` and greedy-decode ``ref["decode_steps"]`` steps in
    ``cfg``; each step's token equal to the file's and its logits at the
    file's indices within its tolerance of max|logit|.  Returns the worst
    error."""
    import numpy as np
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import init_params
    n_prompt, n_dec = len(ref["prompt"]), ref["decode_steps"]
    caches = init_params(0, M.cache_specs_tree(cfg, 1, n_prompt + n_dec,
                                               src_len=src_len),
                         device=device)
    idx = torch.tensor(ref["logit_index"], device=device)
    worst = 0.0
    with torch.no_grad():
        logits, caches = M.prefill(cfg, params, batch, caches)
        for i, step in enumerate(ref["steps"]):
            lg = logits[0].float()
            tok = int(torch.argmax(lg))
            max_abs = float(lg.abs().max())
            err = float(np.max(np.abs(lg[idx].cpu().numpy()
                                      - np.asarray(step["values"]))))
            rel = max(err, abs(max_abs - step["max_abs"])) / step["max_abs"]
            worst = max(worst, rel)
            log(f"[{what}] step {i}: token {tok} (reference {step['token']}) "
                f"max|logit| {max_abs:.5f} (reference {step['max_abs']:.5f})"
                f" err {rel:.2e} of max|logit|")
            if tok != step["token"] or rel > ref["tolerance"]:
                fail(f"{what} step {i} differs from the reference's")
            if i == n_dec:
                break
            logits, caches = M.decode_step(
                cfg, params, {"tokens": torch.tensor(
                    [[step["token"]]], dtype=torch.int32, device=device)},
                caches)
    return worst


def serve_reference_phase(torch, device="cuda"):
    """zamba2-7b at full width, cut to 7 layers, f32 with the kernels,
    against the reference package's prefill and decode logits."""
    ref = json.loads(SERVE_FILE.read_text())
    cfg = serve_reference_config(ref)
    params = reference_params(torch, ref, cfg, device)
    tol = ref["tolerance"]
    reset_model_launches()
    t0 = time.perf_counter()
    worst = reference_steps_check(
        torch, ref, cfg, params, {"tokens": torch.tensor(
            [ref["prompt"]], dtype=torch.int32, device=device)}, 0, device,
        "serve-ref")
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


# the kernels' names in a device trace: flash and the scan on wgmma, on
# mma.sync and on the CUDA cores
MODEL_KERNELS = ("flash_fwd_wgmma_kernel", "flash_fwd_mma_kernel",
                 "flash_fwd_kernel", "ssd_scan_wgmma_kernel",
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


def condition_attention(params):
    """Scale every attention block's projections (each dict of the tree
    holding wq/wk/wv/wo: self, shared and cross attention) to a fan-in of
    d_model for wq/wk/wv and of heads*head_dim for wo.  The reference's
    init rule takes shape[-2] of a rank-3 weight as its fan-in: the head
    count of wq/wk/wv (qwen3-moe's wv comes out ~22x too large) and the
    head_dim of wo (~5.7x), so the softmax saturates and a random model
    amplifies any rounding difference at each attention layer: no two
    implementations then agree end to end.  Returns the same tree, scaled
    in place."""
    if not isinstance(params, dict):
        return params
    if {"wq", "wk", "wv", "wo"} <= params.keys():
        for name in ("wq", "wk", "wv"):
            w = params[name]          # (..., d_model, heads, head_dim)
            w.mul_((w.shape[-2] / w.shape[-3]) ** 0.5)
        params["wo"].mul_((1.0 / params["wo"].shape[-3]) ** 0.5)
        return params
    for sub in params.values():
        condition_attention(sub)
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
    base = torch.cuda.memory_allocated() if on_card else 0
    t0 = time.perf_counter()
    tok, caches = prefill_step(params16, {"tokens": prompts}, caches)
    sync(torch, device)
    prefill_s = time.perf_counter() - t0
    record_step(torch, "full", cfg16, prefill_s,
                (params16, {"tokens": prompts}, caches), base, device)
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
        want = {"flash_fwd_wgmma_kernel": n_attn, "flash_fwd_mma_kernel": 0,
                "flash_fwd_kernel": 0, "ssd_scan_wgmma_kernel": n_ssd,
                "ssd_scan_mma_kernel": 0, "ssd_scan_kernel": 0}
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
    """The port's ServingEngine on a model in f32 (zamba2-7b at full depth;
    qwen3-moe-30b-a3b at 2 layers, where every prompt and its generation
    stay within 512 tokens, so the MoE capacity is dropless in both): each
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
    log(f"[engine] {cfg.name} f32: {n_req} requests (prompts "
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
    condition_attention(params)
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


def range_class(evt, ranges=TRAIN_RANGES):
    """The class of the innermost of ``ranges`` around a CPU op, or
    None."""
    while evt is not None:
        for cls, tag in ranges:
            if evt.name.endswith(tag):
                return cls
        evt = evt.cpu_parent
    return None


def profile_ranges(torch, what, fn, unprofiled_ms, ranges):
    """Device ms of one call by class: the flash and SSD kernels by name;
    every other kernel by the innermost of ``ranges`` ((class, CPU range
    name) pairs: autograd nodes, `record_function` ranges) that launched
    it, as "{class}.gemm" and "{class}.elementwise"; the rest as "gemm" or
    "elementwise".  The idle share is taken against ``unprofiled_ms``, the
    call's time without the profiler (which slows the host's launches).
    A range that linked no kernel is logged as not measured."""
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
    inside = {cls: dict.fromkeys(total, 0.0) for cls, _ in ranges}
    for evt in events:
        if evt.device_type != DeviceType.CPU or not evt.kernels:
            continue
        cls = range_class(evt, ranges)
        if cls is not None:
            for k in evt.kernels:
                inside[cls][kernel_class(k.name)] += k.duration / 1e3
    classes = {"flash_fwd": total["flash_fwd"],
               "ssd_scan": total["ssd_scan"]}
    for cls, part in inside.items():
        for kind in ("gemm", "elementwise"):
            classes[f"{cls}.{kind}"] = part[kind]
    for kind in ("gemm", "elementwise"):
        classes[kind] = total[kind] - sum(p[kind] for p in inside.values())
    busy = sum(total.values())
    top = sorted(names.items(), key=lambda kv: -kv[1])[:8]
    own = {cls: {k: round(part[k], 3) for k in ("flash_fwd", "ssd_scan")}
           for cls, part in inside.items()
           if part["flash_fwd"] or part["ssd_scan"]}
    log(f"[profile] {what}: wall_ms={wall:.1f} (under the profiler) "
        f"kernels={n} device_ms={busy:.1f} by class "
        f"{json.dumps({k: round(v, 3) for k, v in classes.items()})}; "
        f"flash/SSD kernels inside the ranges {json.dumps(own)} (in their "
        f"kernel classes); idle share against the unprofiled "
        f"{unprofiled_ms:.1f} ms {max(0.0, 1 - busy / unprofiled_ms):.3f}; "
        f"top {json.dumps([(k[:60], round(v, 3)) for k, v in top])}")
    for cls, part in inside.items():
        if not sum(part.values()):
            log(f"[profile] {what}: the profile linked no kernel to {cls}'s "
                f"range: its class reads 0 (not measured)")
    return dict(classes, device_ms=busy,
                idle_share=max(0.0, 1 - busy / unprofiled_ms),
                range_ms={cls: sum(part.values())
                          for cls, part in inside.items()})


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
    c16 = cfg.replace(dtype="bfloat16")
    ck, cp = c16.replace(use_pallas=True), c16.replace(use_pallas=False)
    toks = batch["tokens"]
    B, S = toks.shape
    pos = torch.broadcast_to(torch.arange(S, device=toks.device), (B, S))
    gen = torch.Generator(device=toks.device)
    gen.manual_seed(23)
    worst, n_leaves, zero = ("", 0.0), 0, []
    per_layer = []
    reset_model_launches()
    with torch.no_grad():
        x = L.embed_tokens({"embedding": _cast(params["embed"]["embedding"],
                                               c16)}, toks, c16)
    for gi, g in enumerate(cfg.groups):
        gp = params["decoder"][f"g{gi}"]
        for r in range(g.repeat):
            ps = M._index_tree(gp, r)
            for li, ls in enumerate(g.layers):
                where = f"g{gi}.r{r}.L{li}"
                probe = torch.randn(x.shape, generator=gen,
                                    device=x.device)
                shared = params["shared_attn"] if ls.shared_attn else None
                _, gk = layer_grads(torch, ck, ls, ps[f"L{li}"], shared, x,
                                    probe, pos)
                x, gp_ = layer_grads(torch, cp, ls, ps[f"L{li}"], shared, x,
                                     probe, pos)
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


def dots_check(torch, cfg, params, batch, device, tol=1e-5):
    """One f32 train step through the kernels under remat "dots" against
    the same step under "full": the loss and every gradient leaf equal,
    or within ``tol`` relative (L2 for a leaf) where a CUDA reduction
    adds in another order from one run to the next; both launch
    `flash_fwd` and `ssd_scan` in the forward and again in the recompute
    (the reference recomputes its `pallas_call`s under this policy)."""
    c = cfg.replace(dtype="float32")
    lf, gf, tf, nf = route_grads(torch, c.replace(remat="full"), params,
                                 batch, device, True)
    ld, gd, td, nd = route_grads(torch, c.replace(remat="dots"), params,
                                 batch, device, True)
    per, total = grad_errors(gd, gf)
    worst = max(per, key=per.get)
    equal = sum(bool(torch.equal(gd[p], gf[p])) for p in gf)
    loss_rel = abs(ld - lf) / abs(lf)
    log(f"[train] f32 remat dots vs full, kernels on: loss {ld:.6f} vs "
        f"{lf:.6f} ({'equal' if ld == lf else f'rel {loss_rel:.3e}'}); "
        f"{equal} of {len(gf)} gradient leaves bit-equal, worst "
        f"{worst} rel L2 {per[worst]:.3e}, all leaves {total:.3e} (limit "
        f"{tol:g}); launches {json.dumps(nd)} (full {json.dumps(nf)}); "
        f"gradient {td:.2f}s (full {tf:.2f}s)")
    if nd != nf:
        fail(f"the dots step launched {nd}, the full step {nf}")
    if not (loss_rel <= tol and per[worst] <= tol):
        fail(f"f32 remat dots differs from full: loss {loss_rel:.3e}, "
             f"leaf {worst} {per[worst]:.3e} (limit {tol:g})")
    return {"loss_rel": loss_rel, "equal_leaves": equal,
            "leaves": len(gf), "worst_leaf": worst,
            "worst_rel_l2": per[worst], "launches": nd}


def grad_peak_gib(torch, cfg, params, batch, device):
    """The card's high-water mark over one gradient of ``cfg`` (forward
    and backward, no update), above what it held before: what the saved
    activations cost.  0 off the card."""
    from repro_torch.training.train_state import loss_and_grads
    if device != "cuda":
        return 0.0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    met, grads = loss_and_grads(cfg, params, batch)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    del met, grads
    return peak


def timed_steps(torch, cfg, state, batch, n_steps, device, what):
    """``n_steps`` timed train steps of ``cfg`` after one warm-up, from
    ``state`` (returned with the steps taken): the median step s, each
    step's s and loss, the kernels' launches over the timed steps, the
    peak memory, and a profile of one more step by class."""
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training.train_state import make_train_step
    step = make_train_step(cfg, AdamWConfig())
    state, met = step(state, batch)                 # warm-up
    sync(torch, device)
    base = 0
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    reset_model_launches()
    times, losses = [], [float(met["loss"])]
    for _ in range(n_steps):
        sync(torch, device)
        t0 = time.perf_counter()
        state, met = step(state, batch)
        sync(torch, device)
        times.append(time.perf_counter() - t0)
        losses.append(float(met["loss"]))
    med = statistics.median(times)
    run = {"state": state, "step_s": med, "times": times, "losses": losses,
           "launches": model_launches(), "base": base,
           "peak_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                        if device == "cuda" else 0.0)}
    if not all(math.isfinite(x) for x in losses):
        fail(f"{what}: train losses not finite: {losses}")
    run["classes"] = (profile_ranges(torch, what, lambda: step(state, batch),
                                     med * 1e3, TRAIN_RANGES)
                      if device == "cuda" else {})
    return run


def train_step_phase(torch, cfg=None, device="cuda", B=2, S=2048, seed=17,
                     n_steps=3):
    """zamba2-7b at full width, cut to 13 layers (13 SSD layers, 2
    shared-attention hits): one train step's loss and gradients through
    the kernels against the plain torch paths in bf16 and in f32, and
    under remat "dots" against "full" in f32 (`dots_check`); then
    ``n_steps`` timed bf16 AdamW steps after one warm-up under remat
    "full" and again under "dots", each with its launches, peak memory
    and a profile of one step by class.  (``cfg`` and ``device`` let it
    be rehearsed small on the CPU.)"""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    from repro_torch.models.convert import params_from_reference
    from repro_torch.parallel.sharding import init_params_numpy
    cfg = (cfg or get_config("zamba2-7b").replace(groups=train_groups())
           ).replace(remat="full")
    specs = M.model_param_specs(cfg)
    n_params = M.count_params(cfg)
    n_ssd, n_attn = layer_counts(cfg)
    t0 = time.perf_counter()
    tree = init_params_numpy(seed, specs)
    params = params_from_reference(tree, specs, device=device)
    del tree
    condition_attention(params)
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
    routes["dots"] = dots_check(torch, cfg, params, batch, device)
    if device == "cuda":
        torch.cuda.empty_cache()

    # ---- the main path: timed AdamW steps, remat "full", then "dots" ---- #
    c16 = cfg.replace(dtype="bfloat16", use_pallas=True)
    state = {"params": params,
             "opt": {k: _zeros_like(torch, params) for k in ("m", "v")},
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    want = (route_counts(2 * n_attn * n_steps, 2 * n_ssd * n_steps,
                         2 * n_attn * n_steps, 2 * n_ssd * n_steps)
            if device == "cuda" else route_counts(0, 0, 0, 0))
    flop = 8 * n_params * B * S
    runs = {}
    for remat in ("full", "dots"):
        c = c16.replace(remat=remat)
        run = runs[remat] = timed_steps(
            torch, c, state, batch, n_steps, device,
            f"one bf16 train step, remat {remat}")
        state = run.pop("state")
        if remat == "full":
            record_step(torch, "train", c, run["step_s"], (state, batch),
                        run["base"], device)
        if run["launches"] != want:
            fail(f"{n_steps} bf16 train steps under remat {remat} launched "
                 f"{run['launches']}, expected {want}")
        med = run["step_s"]
        log(f"[train] bf16 AdamW step, remat {remat}: median {med:.4f}s "
            f"over {n_steps} steps (each "
            f"{json.dumps([round(x, 4) for x in run['times']])}) = "
            f"{B * S / med:.0f} tokens/s; model FLOP 8*N*T = {flop:.3e} "
            f"({flop / med / 1e12:.1f} TFLOP/s, "
            f"{flop / med / BF16_OPS_PER_S:.3f} of the bf16 dense peak); "
            f"peak memory {run['peak_gib']:.2f} GiB; losses "
            f"{json.dumps([round(x, 5) for x in run['losses']])}; launches "
            f"over the {n_steps} steps {json.dumps(run['launches'])}")
    full, dots = runs["full"], runs["dots"]
    rec_ms = {k: r["classes"].get("range_ms", {}).get("recompute", 0.0)
              for k, r in runs.items()}
    grad_peak = {r: grad_peak_gib(torch, c16.replace(remat=r),
                                  state["params"], batch, device)
                 for r in ("full", "dots")}
    log(f"[train] remat dots beside full (bf16, {card_or_cpu(device)}): "
        f"step {dots['step_s']:.4f}s vs {full['step_s']:.4f}s "
        f"({dots['step_s'] / full['step_s'] - 1:+.2%}), tokens/s "
        f"{B * S / dots['step_s']:.0f} vs {B * S / full['step_s']:.0f}, "
        f"peak {dots['peak_gib']:.2f} vs {full['peak_gib']:.2f} GiB "
        f"({dots['peak_gib'] - full['peak_gib']:+.2f}), a gradient's own "
        f"peak above its inputs {grad_peak['dots']:.2f} vs "
        f"{grad_peak['full']:.2f} GiB, device ms under "
        f"remat_recompute {rec_ms['dots']:.1f} vs {rec_ms['full']:.1f}, "
        f"device ms a step {dots['classes'].get('device_ms', 0):.1f} vs "
        f"{full['classes'].get('device_ms', 0):.1f}; launches a step "
        f"{json.dumps({k: v // n_steps for k, v in dots['launches'].items()})}"
        f" both")
    return {"step_s": full["step_s"],
            "tokens_per_s": B * S / full["step_s"],
            "peak_gib": full["peak_gib"], "launches": full["launches"],
            "per_step": {k: v // n_steps for k, v in full["launches"].items()},
            "classes": full["classes"], "routes": routes,
            "dots": {"step_s": dots["step_s"], "peak_gib": dots["peak_gib"],
                     "grad_peak_gib": grad_peak,
                     "recompute_ms": rec_ms["dots"],
                     "per_step": {k: v // n_steps
                                  for k, v in dots["launches"].items()}}}


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
    from repro_torch.core import Agent
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import tree_leaves_with_path
    from repro_torch.serving.engine import ServeConfig, ServingEngine
    ref = json.loads(SERVE_FILE.read_text())
    cfg = cfg or serve_reference_config(ref)
    want = want or [s["token"] for s in ref["steps"]]
    specs = M.model_param_specs(cfg)
    root = ROOT / "build" / "chip_swarm"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    tree = reference_tree(ref["seed"], cfg)
    draw_s = time.perf_counter() - t0
    store = CheckpointStore(str(root / "origin"))
    t0 = time.perf_counter()
    store.save(0, tree, extra={"arch": ref["arch"], "seed": ref["seed"]})
    save_s = time.perf_counter() - t0
    app = checkpoint_application(store, host_id="origin")
    rt, replicas, fetch_s = swarm_fetch(app, n_replicas)
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
    reference_tree.cache_clear()
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


# =================== the examples on the card ============================ #
EXAMPLES = (("examples/port_serve_lm.py",),
            ("examples/port_train_lm.py", "--size", "tiny", "--steps", "10",
             "--ckpt-dir", "build/chip_examples"))


def examples_phase(limit=300.0, device=None):
    """The port's examples as child processes side by side (each on the
    card, their default, unless ``device`` names another): their output
    logged, a non-zero exit or an overrun of ``limit`` seconds a failure.
    The train example's checkpoints go under build/ and are deleted."""
    import shutil
    env = dict(os.environ, PYTHONPATH=str(SRC))
    extra = ("--device", device) if device else ()
    t0 = time.perf_counter()
    procs = [(args[0], subprocess.Popen(
        [sys.executable, *args, *extra], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for args in EXAMPLES]
    try:
        for name, proc in procs:
            try:
                out, err = proc.communicate(
                    timeout=max(1.0, limit - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                fail(f"{name} ran past {limit:.0f}s")
            for line in out.splitlines():
                log(f"[example] {name}: {line}")
            if proc.returncode:
                fail(f"{name} exited {proc.returncode}: {err[-2000:]}")
            log(f"[time] {name} done {time.perf_counter() - t0:.1f}s after "
                f"the examples started ({card_or_cpu(device or 'cuda')})")
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(ROOT / "build" / "chip_examples", ignore_errors=True)


# ============ the paper's experiments and the torrent ring ================ #
# the entries of reference_runs.json that paper_tables_phase runs: Tables
# I and IV (six volunteers, the paper's largest), Scenarios V, VI and XI
# at their defaults.  Tables II and III take Table I's and IV's path; the
# CPU tests hold them (tests/test_torch_paper_tables.py).
# XI at R=8 replicas of 256 MB (`reference_runs.json`'s "xi_r8_256mb"):
# R=50 of 2 GB ("xi_r50", ~60 s) held the script ~60 s past the kernel
# phase, and the whole script near its time limit
PAPER_RUNS = ("table1", "table4", "scenario_v", "scenario_vi",
              "xi_r8_256mb")


@functools.lru_cache(maxsize=1)
def card():
    """`nvidia-smi`'s name and power limit of the card, one line."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def paper_tables_phase(scenarios, names=PAPER_RUNS):
    """The source paper's experiments on the port's scalar protocol: each
    entry's virtual-time fields must equal reference_runs.json (taken
    from the reference under PYTHONHASHSEED=0); prints each run's lines
    and wall seconds (the host's: no device is involved)."""
    golden = json.loads(RUNS_FILE.read_text())
    if golden.get("pythonhashseed") != os.environ.get("PYTHONHASHSEED"):
        fail("expected values were taken under another PYTHONHASHSEED")
    walls = {}
    for name in names:
        entry = golden["runs"][name]
        t0 = time.perf_counter()
        res = getattr(scenarios, entry["scenario"])(**entry["params"])
        walls[name] = time.perf_counter() - t0
        got = json.loads(json.dumps(
            scenarios.virtual_time_fields(entry["scenario"], res)))
        if got != entry["result"]:
            log(f"[paper] {name} result {json.dumps(got)}")
            fail(f"{name}: the port's results differ from "
                 "reference_runs.json")
        log(f"[paper] {name} {json.dumps(entry['params'])}: wall "
            f"{walls[name]:.3f}s on the host ({card()}); every virtual-time "
            f"field equals reference_runs.json")
    return walls


def start_paper_tables():
    """`paper_tables_phase` in a child process (`--paper-tables`): host
    work only, so it runs beside the kernel build and the kernel phase,
    whose times are device times.  Its output goes to a file under
    build/; `finish_paper_tables` joins it."""
    import atexit
    out = ROOT / "build" / "chip_paper_tables.log"
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--paper-tables"],
            stdout=f, stderr=subprocess.STDOUT)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, out, time.perf_counter()


def finish_paper_tables(started, limit=900.0):
    proc, out, t0 = started
    t_wait = time.perf_counter()
    try:
        proc.wait(timeout=limit)
    except subprocess.TimeoutExpired:
        proc.kill()
        fail(f"the paper tables outlasted {limit} s")
    for line in out.read_text().splitlines():
        log(line)
    if proc.returncode != 0:
        fail(f"the paper-tables phase failed ({proc.returncode})")
    log(f"[time] paper-tables phase {time.perf_counter() - t0:.1f}s beside "
        f"the build and the kernel phase; waited "
        f"{time.perf_counter() - t_wait:.1f}s for it after them")


def swarm_fetch(app, n_replicas):
    """Replicas R0.. fetch the checkpoint Application ``app`` from its
    origin through the scalar protocol at 10 Gb/s; returns (runtime,
    replicas, wall seconds).  Fails unless every replica completes the
    piece set."""
    from repro_torch.core import (Agent, AgentConfig, LinkModel, SimRuntime,
                                  TrackerConfig, TrackerServer)
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
    if not all(app.app_id in r.images for r in replicas):
        fail("the replicas did not complete the checkpoint's piece set")
    return rt, replicas, time.perf_counter() - t0


def leaf_digests(tree):
    """sha256 of each leaf's bytes, by path (tensors or numpy arrays)."""
    import hashlib
    import numpy as np
    from repro_torch.parallel.sharding import tree_leaves_with_path
    out = {}
    for path, leaf in tree_leaves_with_path(tree):
        if not isinstance(leaf, np.ndarray):
            leaf = leaf.detach().cpu().contiguous().numpy()
        out[path] = hashlib.sha256(np.ascontiguousarray(leaf)
                                   .view(np.uint8)).hexdigest()
    return out


def torrent_rank(rank, world, init_file, root, cfg, want, backend, device,
                 results):
    """One rank of `torrent_restore_phase` (a spawned process): see there.
    Reports a dict of its readings, or its traceback, on ``results``."""
    import traceback
    try:
        results.put((rank, "ok", _torrent_rank(rank, world, init_file, root,
                                               cfg, want, backend, device)))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))


def _torrent_rank(rank, world, init_file, root, cfg, want, backend, device):
    import datetime
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.checkpoint.swarm_restore import checkpoint_application
    from repro_torch.models import model as M
    from repro_torch.parallel import weight_torrent as wt
    from repro_torch.parallel.pipeline import pipeline_apply
    from repro_torch.serving.engine import ServeConfig, ServingEngine
    if device == "cuda":
        # as main() sets them for the serve slice's reference checks
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(rank if backend == "nccl" else 0)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=600))
    try:
        mesh = init_device_mesh("cuda" if backend == "nccl" else "cpu",
                                (world,), mesh_dim_names=("pod",))
        out = {"rank": rank}
        specs = M.model_param_specs(cfg)
        store = CheckpointStore(str(Path(root) / "origin"))
        if backend == "gloo":
            agent = app_id = None
            if rank == 0:
                app = checkpoint_application(store, host_id="origin")
                app_id = app.app_id
                rt, (agent,), out["fetch_s"] = swarm_fetch(app, 1)
                out["fetch_virtual_s"] = rt.now()
                out["origin_egress"] = rt.tx_bytes.get("origin", 0)
            prompt = np.asarray(json.loads(SERVE_FILE.read_text())["prompt"],
                                np.int32)
            sc = ServeConfig(slots=1, max_len=len(prompt) + len(want) + 1)
            wt.reset_stats()
            dist.barrier()
            t0 = time.perf_counter()
            eng = ServingEngine.from_swarm(
                cfg, specs, sc, agent=agent, app_id=app_id,
                workdir=str(Path(root) / f"rank{rank}"), mesh=mesh,
                device=device)
            sync(torch, device)
            out["from_swarm_s"] = time.perf_counter() - t0
            out["from_swarm_ring"] = dict(wt.STATS)
            digests = leaf_digests(eng.params)
            every = [None] * world
            dist.all_gather_object(every, digests)
            out["from_swarm_equal"] = all(d == every[0] for d in every)
            out["digests"] = digests if rank == 0 else None
            out["leaf_devices"] = sorted({t.device.type for t in
                                          _leaves(eng.params)})
            reset_model_launches()
            eng.submit(prompt, max_new=len(want))
            (req,) = list(eng.queue)
            t0 = time.perf_counter()
            while eng.queue or eng.active:
                eng.step()
            sync(torch, device)
            out["serve_s"] = time.perf_counter() - t0
            out["tokens"] = req.out_tokens
            out["launches"] = model_launches()
            del eng
            if device == "cuda":
                torch.cuda.empty_cache()
        # straight from the store (only the seeder reads it)
        wt.reset_stats()
        dist.barrier()
        t0 = time.perf_counter()
        tree, extra = store.restore_distributed(specs, mesh, device=device)
        sync(torch, device)
        out["restore_s"] = time.perf_counter() - t0
        out["restore_ring"] = dict(wt.STATS)
        out["extra"] = extra
        digests = leaf_digests(tree)
        every = [None] * world
        dist.all_gather_object(every, digests)
        out["restore_equal"] = all(d == every[0] for d in every)
        out["restore_digests"] = digests if rank == 0 else None
        del tree
        if backend == "gloo":
            # the reference mesh check's pipeline: L=4 stages of
            # tanh(x @ w) on the card, M=6 microbatches of (2, 16), the
            # activations crossing the gloo group as CPU tensors
            g = torch.Generator().manual_seed(0)
            ws = (torch.randn((world, 16, 16), generator=g) * 0.3).to(device)
            xs = torch.randn((6, 2, 16), generator=g).to(device)

            def stage(w, x):
                return torch.tanh(x @ w)

            got = pipeline_apply(stage, ws, xs, mesh, axis="pod")
            seq = xs
            for s in range(world):
                seq = stage(ws[s], seq)
            out["pipeline_err"] = float((got - seq).abs().max())
            out["pipeline_device"] = got.device.type
        return out
    finally:
        dist.destroy_process_group()


def _leaves(tree):
    from repro_torch.parallel.sharding import tree_leaves_with_path
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def spawn_ranks(world, root, cfg, want, backend, device, limit):
    """``world`` spawned `torrent_rank` processes on one process group;
    returns their readings in rank order.  Fails, after killing every
    rank, when a rank raises, dies or they outlast ``limit`` seconds."""
    import multiprocessing
    import queue
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init_file = Path(root) / f"pg_{backend}"
    init_file.unlink(missing_ok=True)
    procs = [ctx.Process(target=torrent_rank, daemon=True,
                         args=(r, world, str(init_file), str(root), cfg,
                               want, backend, device, results))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + limit
    got, errors = {}, []
    try:
        while len(got) < world and not errors:
            try:
                rank, status, out = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if dead:
                    errors.append(f"ranks {dead} exited without a result")
                elif time.monotonic() > deadline:
                    errors.append(f"the ranks outlasted {limit} s")
                continue
            if status == "error":
                errors.append(f"rank {rank}:\n{out}")
            got[rank] = out
        for p in procs if not errors else ():
            p.join(timeout=max(0.0, deadline - time.monotonic()) + 10.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    if errors:
        fail(f"torrent ranks ({backend}): " + "\n".join(errors))
    return [got[r] for r in range(world)]


def torrent_restore_phase(torch, cfg=None, want=None, device="cuda",
                          world=4, limit=900.0):
    """The torrent ring across ranks.  The 7-layer f32 zamba2 of
    `swarm_restore_phase` (789 swarm pieces of 4 MB) is saved once;
    ``world`` spawned ranks join one gloo `DeviceMesh` with axis
    ("pod",); rank 0 fetches the checkpoint as one replica through the
    scalar protocol; every rank calls `ServingEngine.from_swarm(...,
    mesh=mesh, device=device)`, ranks 1.. receiving the params over the
    ring; every rank's leaves must be bit-equal to rank 0's (a digest per
    leaf, gathered) and to the saved arrays, and every rank must serve
    `reference_serve.json`'s greedy tokens on ``device`` (all ranks share
    cuda:0).  Then `restore_distributed` straight from the store on the
    same mesh, held to the same leaves, and `pipeline_apply` at the
    reference check's shapes (stages on ``device``, activations through
    the gloo group as CPU tensors) within 1e-5 of the sequential result.
    With two cards or more, `restore_distributed` also runs on an NCCL
    mesh over min(4, count) cards.  Prints the ring's seconds, each rank's
    bytes sent and the seeder's upload as a multiple of the image.
    (A CPU rehearsal passes a small ``cfg`` and the tokens ``want``.)"""
    import shutil
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import init_params_numpy
    ref = json.loads(SERVE_FILE.read_text())
    cfg = cfg or serve_reference_config(ref)
    want = want or [s["token"] for s in ref["steps"]]
    root = ROOT / "build" / "chip_torrent"
    shutil.rmtree(root, ignore_errors=True)
    tree = init_params_numpy(ref["seed"], M.model_param_specs(cfg))
    saved = leaf_digests(tree)
    image = sum(a.nbytes for a in _leaves(tree))
    t0 = time.perf_counter()
    CheckpointStore(str(root / "origin")).save(
        0, tree, extra={"arch": ref["arch"], "seed": ref["seed"]})
    save_s = time.perf_counter() - t0
    del tree
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    outs = spawn_ranks(world, root, cfg, want, "gloo", device, limit)
    wall = time.perf_counter() - t0
    if outs[0]["digests"] != saved or outs[0]["restore_digests"] != saved:
        fail("the seeder's restored leaves differ from the saved ones")
    for o in outs:
        r = o["rank"]
        if not (o["from_swarm_equal"] and o["restore_equal"]):
            fail(f"rank {r}: the ranks' leaves differ")
        if o["leaf_devices"] != [device]:
            fail(f"rank {r}: leaves on {o['leaf_devices']}")
        if o["tokens"] != want:
            fail(f"rank {r} served {o['tokens']}, expected {want}")
        if o["extra"] != {"arch": ref["arch"], "seed": ref["seed"]}:
            fail(f"rank {r}: extra {o['extra']}")
        if not o["pipeline_err"] <= 1e-5 or o["pipeline_device"] != device:
            fail(f"rank {r}: pipeline_apply off by {o['pipeline_err']} "
                 f"on {o['pipeline_device']}")
        for what in ("from_swarm_ring", "restore_ring"):
            ring = o[what]
            sent = ring.get("sent_bytes", 0)
            if sent != (0 if r == world - 1 else outs[0][what]["sent_bytes"]):
                fail(f"rank {r} sent {sent} bytes in {what}")
            log(f"[torrent] {what} rank {r}: ring {ring.get('seconds', 0):.3f}"
                f"s, {ring.get('ring_steps', 0)} steps, sent {sent} bytes, "
                f"received {ring.get('received_bytes', 0)} ({card()})")
    o0 = outs[0]
    for what, ring, secs in (
            ("from_swarm", "from_swarm_ring", "from_swarm_s"),
            ("restore_distributed", "restore_ring", "restore_s")):
        sent0 = o0[ring]["sent_bytes"]
        log(f"[torrent] {what} over {world} gloo ranks: {image} image "
            f"bytes; the seeder uploaded {sent0} bytes = "
            f"{sent0 / image:.4f} x the image (a fan-out to {world - 1} "
            f"ranks: {world - 1}.0 x); rank seconds "
            f"{[round(o[secs], 3) for o in outs]} ({card()})")
    log(f"[torrent] {ref['arch']} {len(cfg.groups)} groups: saved in "
        f"{save_s:.2f}s; rank 0 fetched {o0['fetch_virtual_s']:.3f} "
        f"virtual s, {o0['fetch_s']:.2f} wall s (origin egress "
        f"{o0['origin_egress']} bytes); every rank's leaves equal the saved "
        f"ones, on {device}; every rank served {want} in "
        f"{[round(o['serve_s'], 2) for o in outs]} s (model kernel "
        f"launches of rank 0's serve: {json.dumps(o0['launches'])}: the "
        f"engine feeds every token through the decode step); "
        f"pipeline_apply max err "
        f"{max(o['pipeline_err'] for o in outs):.3e}; ranks' wall "
        f"{wall:.1f}s ({card()})")
    n_cards = torch.cuda.device_count() if device == "cuda" else 0
    if n_cards >= 2:
        k = min(4, n_cards)
        nccl = spawn_ranks(k, root, cfg, want, "nccl", device, limit)
        for o in nccl:
            if o["restore_digests"] not in (None, saved) or \
                    not o["restore_equal"]:
                fail(f"NCCL rank {o['rank']}: leaves differ")
        sent0 = nccl[0]["restore_ring"]["sent_bytes"]
        log(f"[torrent] restore_distributed over {k} NCCL ranks (one card "
            f"each): ring {nccl[0]['restore_ring']['seconds']:.3f}s, seeder "
            f"upload {sent0 / image:.4f} x the image, rank seconds "
            f"{[round(o['restore_s'], 3) for o in nccl]} ({card()})")
    else:
        log(f"[torrent] the NCCL ring did not run: {n_cards} card(s), and "
            "NCCL refuses two ranks on one card")
    shutil.rmtree(root, ignore_errors=True)
    return {"wall_s": wall, "outs": outs}


# =============== MoE and encoder-decoder slice =========================== #
MOE_FILE = SRC / "repro_torch" / "reference_serve_moe.json"
ENCDEC_FILE = SRC / "repro_torch" / "reference_serve_encdec.json"
# CPU ranges (named by `hooked`, in `slice_ranges`) that the profile
# charges kernels to: the MoE router, the whole MoE block, cross attention
# and its k/v projection
MOE_RANGES = (("router", "moe_router"), ("moe", "moe_block"))
CROSS_RANGES = (("cross", "cross_attention"),)


@contextlib.contextmanager
def hooked(module, name, after=None, tag=None):
    """``module.name`` wrapped for the block: run under a profiler range
    ``tag``, and ``after(args, result)`` called on each call."""
    import torch
    inner = getattr(module, name)

    def call(*args, **kw):
        if tag is None:
            out = inner(*args, **kw)
        else:
            with torch.profiler.record_function(tag):
                out = inner(*args, **kw)
        if after is not None:
            after(args, out)
        return out
    setattr(module, name, call)
    try:
        yield
    finally:
        setattr(module, name, inner)


@contextlib.contextmanager
def slice_ranges():
    """The profiler ranges of MOE_RANGES and CROSS_RANGES around the
    port's functions."""
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import moe as moe_lib
    with contextlib.ExitStack() as stack:
        stack.enter_context(hooked(moe_lib, "_route", tag="moe_router"))
        stack.enter_context(hooked(moe_lib, "moe_block", tag="moe_block"))
        for name in ("cross_attention_block", "encode_cross_kv"):
            stack.enter_context(hooked(attn_lib, name,
                                       tag="cross_attention"))
        yield


def decode_syncs(torch, fn):
    """Host syncs of one call: the warnings of
    `torch.cuda.set_sync_debug_mode("warn")`."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return [str(w.message).splitlines()[0] for w in seen
            if "called a synchronizing" in str(w.message)]


def moe_reference_phase(torch, device="cuda"):
    """qwen3-moe-30b-a3b at full width, 2 layers, f32 with the kernels,
    against `reference_serve_moe.json`: tokens, logits, and every MoE
    call's per-expert counts and dropped assignments (the 1280-token
    prefill is past 512 tokens: the capacity rule drops).  Returns (cfg,
    params) for the engine check."""
    import numpy as np
    from repro_torch.models import moe as moe_lib
    ref = json.loads(MOE_FILE.read_text())
    cfg = serve_reference_config(ref)
    params = reference_params(torch, ref, cfg, device)
    calls = []

    def record(args, out):
        calls.append((args[2].cpu().numpy(), args[7]))   # experts, capacity
    reset_model_launches()
    t0 = time.perf_counter()
    with hooked(moe_lib, "_dispatch_compute", after=record):
        worst = reference_steps_check(
            torch, ref, cfg, params, {"tokens": torch.tensor(
                [ref["prompt"]], dtype=torch.int32, device=device)}, 0,
            device, "moe-ref")
    launched = model_launches()
    n_attn = sum(g.repeat * len(g.layers) for g in cfg.groups)
    want = (route_counts(n_attn, 0, 0, 0) if device == "cuda"
            else route_counts(0, 0, 0, 0))     # f32: the CUDA-core kernel
    if launched != want:
        fail(f"2-layer f32 qwen3-moe launched {launched}, expected {want}")
    if len(calls) != len(ref["routing"]):
        fail(f"{len(calls)} MoE calls, the reference made "
             f"{len(ref['routing'])}")
    drops = []
    for i, ((experts, cap), want) in enumerate(zip(calls, ref["routing"])):
        counts = np.bincount(experts.reshape(-1), minlength=cfg.num_experts)
        dropped = int(np.maximum(counts - cap, 0).sum())
        drops.append(dropped)
        if (cap, counts.tolist(), dropped) != (want["capacity"],
                                               want["counts"],
                                               want["dropped"]):
            if "experts" in want:
                flipped = np.nonzero((np.sort(experts, axis=1)
                                      != np.asarray(want["experts"])
                                      ).any(axis=1))[0]
                log(f"[moe-ref] MoE call {i}: tokens whose experts differ "
                    f"from the reference's: {flipped.tolist()[:50]} "
                    f"({len(flipped)} of {len(experts)})")
            fail(f"MoE call {i}: capacity {cap}, dropped {dropped}, counts "
                 f"differ from the reference's (capacity "
                 f"{want['capacity']}, dropped {want['dropped']})")
    log(f"[moe-ref] matches reference_serve_moe.json (worst {worst:.2e} of "
        f"max|logit| <= {ref['tolerance']}; {len(calls)} MoE calls with "
        f"equal expert counts, prefill drops {drops[:n_attn]} at capacity "
        f"{calls[0][1]}) in {time.perf_counter() - t0:.1f}s, launches "
        f"{json.dumps(launched)}")
    return cfg, params


def encdec_reference_phase(torch, device="cuda"):
    """seamless-m4t-medium whole (12 + 12 layers), f32 with the kernels,
    against `reference_serve_encdec.json`: 1280 encoder frames (the
    encoder takes flash), a 320-token target prompt, 8 decode steps."""
    import numpy as np
    ref = json.loads(ENCDEC_FILE.read_text())
    cfg = serve_reference_config(ref)
    params = reference_params(torch, ref, cfg, device)
    rng = np.random.default_rng(ref["seed"])
    prompt = rng.integers(0, cfg.vocab_size, (1, len(ref["prompt"])))
    idx = rng.choice(cfg.vocab_size, len(ref["logit_index"]), replace=False)
    frames = rng.standard_normal((1, ref["src_len"], cfg.d_model),
                                 dtype=np.float32)
    got = float(np.sum(np.abs(frames), dtype=np.float64))
    if (prompt[0].tolist() != ref["prompt"]
            or sorted(idx.tolist()) != ref["logit_index"]
            or abs(got - ref["frames_abs_sum"]) > 1e-9 * got):
        fail("the frames drawn here differ from the reference's")
    reset_model_launches()
    t0 = time.perf_counter()
    worst = reference_steps_check(
        torch, ref, cfg, params,
        {"tokens": torch.tensor(prompt, dtype=torch.int32, device=device),
         "enc_embeds": torch.from_numpy(frames).to(device)},
        ref["src_len"], device, "encdec-ref")
    launched = model_launches()
    n_enc = sum(g.repeat * len(g.layers) for g in cfg.encoder_groups)
    want = (route_counts(n_enc, 0, 0, 0) if device == "cuda"
            else route_counts(0, 0, 0, 0))
    if launched != want:
        fail(f"f32 seamless launched {launched}, expected {want}")
    log(f"[encdec-ref] matches reference_serve_encdec.json (worst "
        f"{worst:.2e} of max|logit| <= {ref['tolerance']}) in "
        f"{time.perf_counter() - t0:.1f}s, launches {json.dumps(launched)}")
    del params


def serve_run(torch, cfg, params, batch, n_decode, src_len, want_flash,
              device, what, ranges):
    """A bf16 prefill of ``batch`` and ``n_decode`` greedy decode steps
    through the port's prefill / decode steps, with `flash_fwd`'s launches
    counted over this run alone (``want_flash`` a prefill, all `.wgmma`, none
    in decode), host times, peak memory, a profile by class of the prefill
    and of one decode step (kernels charged to ``ranges`` where they ran
    inside them), and the host syncs of one decode step."""
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import init_params
    from repro_torch.training.train_state import (make_decode_step,
                                                  make_prefill_step)
    on_card = device == "cuda"
    B = batch["tokens"].shape[0]
    cache_len = batch["tokens"].shape[1] + n_decode
    prefill_step, decode_step = make_prefill_step(cfg), make_decode_step(cfg)

    def fresh_caches():
        return init_params(0, M.cache_specs_tree(cfg, B, cache_len,
                                                 src_len=src_len),
                           device=device)

    prefill_step(params, batch, fresh_caches())     # warm-up
    sync(torch, device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_model_launches()
    caches = fresh_caches()
    sync(torch, device)
    base = torch.cuda.memory_allocated() if on_card else 0
    t0 = time.perf_counter()
    tok, caches = prefill_step(params, batch, caches)
    sync(torch, device)
    prefill_s = time.perf_counter() - t0
    record_step(torch, what, cfg, prefill_s, (params, batch, caches), base,
                device)
    per_prefill = model_launches()
    want = (route_counts(want_flash, 0, want_flash, 0) if on_card
            else route_counts(0, 0, 0, 0))
    if per_prefill != want:
        fail(f"{what} prefill launched {per_prefill}, expected {want}")
    toks = [tok]
    t0 = time.perf_counter()
    for _ in range(n_decode):
        tok, caches = decode_step(params, {"tokens": tok[:, None]}, caches)
        toks.append(tok)
    sync(torch, device)
    decode_ms = (time.perf_counter() - t0) * 1e3 / n_decode
    launches = model_launches()
    if launches != per_prefill:
        fail(f"{what} decode launched flash_fwd: {launches}")
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else 0
    with torch.no_grad():
        logits, _ = M.decode_step(cfg, params, {"tokens": tok[:, None]},
                                  caches)
    if tuple(logits.shape) != (B, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        fail(f"{what} decode logits {tuple(logits.shape)} not finite or "
             "mis-shaped")
    log(f"[{what}] {M.count_params(cfg)} params bf16: prefill B={B} "
        f"{ {k: tuple(v.shape) for k, v in batch.items()} } "
        f"{prefill_s:.3f}s = {batch['tokens'].numel() / prefill_s:.0f} "
        f"target tokens/s; decode {decode_ms:.2f} ms/step over {n_decode} "
        f"steps; peak memory {peak_gb:.2f} GiB; launches "
        f"{json.dumps(launches)}")
    out = {"prefill_s": prefill_s, "decode_ms": decode_ms,
           "peak_gib": peak_gb, "launches": launches}
    if on_card:
        with slice_ranges():
            out["prefill_profile"] = profile_ranges(
                torch, f"{what} bf16 prefill",
                lambda: prefill_step(params, batch, fresh_caches()),
                prefill_s * 1e3, ranges)
            out["decode_profile"] = profile_ranges(
                torch, f"{what} bf16 decode step",
                lambda: decode_step(params, {"tokens": toks[-1][:, None]},
                                    caches), decode_ms, ranges)
        syncs = decode_syncs(torch, lambda: decode_step(
            params, {"tokens": toks[-1][:, None]}, caches))
        out["decode_syncs"] = len(syncs)
        log(f"[{what}] host syncs of one decode step: {len(syncs)} "
            f"{json.dumps(sorted(set(syncs))[:5])}")
    return out


def layer_routes(torch, cfg, ls, p, x, pos, mode, causal, enc_kv, device):
    """One layer on input ``x`` through the plain torch paths, then through
    the kernels with the MoE routed to the plain route's experts (the gates
    still from the kernel route's own router probabilities, renormalised
    over those experts): [(out, after_attn, experts)] for (kernels, plain).
    ``after_attn`` is the residual stream after the self-attention
    sub-block, ``experts`` (N, k) the experts the route's own router chose
    (None where the layer does not route).  No cache is written: its k and
    v are projected before any kernel runs."""
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_lib
    route = moe_lib._route
    outs = []
    for c in (cfg.replace(use_pallas=False), cfg.replace(use_pallas=True)):
        chose, attn = [], []
        pin = outs[0][2] if outs else None

        def pinned(xf, w, k):
            gates, experts, probs = route(xf, w, k)
            chose.append(experts)
            if pin is None:
                return gates, experts, probs
            g = probs.gather(1, pin)
            return g / g.sum(-1, keepdim=True).clamp_min(1e-9), pin, probs
        moe_lib._route = pinned
        try:
            with hooked(attn_lib, "attention_block",
                        after=lambda args, out: attn.append(out[0])):
                y, _, _ = M.apply_layer(
                    c, ls, p, x, torch.zeros((), device=device), mode=mode,
                    positions=pos, enc_kv=enc_kv, causal=causal)
        finally:
            moe_lib._route = route
        outs.append((y, x + attn[0], chose[0] if chose else None))
    return outs[::-1]


def layerwise_check(torch, cfg, layers, tol, device, what):
    """Each layer of ``layers`` (functions of the previous layer's plain
    output giving the `layer_routes` arguments between ``cfg`` and
    ``device``) through both routes, every token held within ``tol`` of the
    plain route's max: the residual stream after self-attention (where the
    kernel runs) and the layer's output with the MoE on the plain route's
    experts.  The share of tokens whose own router picks
    agree between the routes is reported (a bf16 rounding difference in the
    attention flips near-tied router choices, and a flip moves the capacity
    cut of the experts it touches).  Returns the worst of each."""
    worst = {"after_attn": 0.0, "out": 0.0, "routing_agreement": 1.0}

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max().clamp_min(1e-30))

    x = None
    with torch.no_grad():
        for i, make in enumerate(layers):
            args = make(x)
            (yk, ak, ek), (yp, ap, ep) = layer_routes(torch, cfg, *args,
                                                      device)
            errs = {"after_attn": rel(ak, ap), "out": rel(yk, yp)}
            if ek is not None:
                worst["routing_agreement"] = min(
                    worst["routing_agreement"],
                    float((ek.sort(dim=-1).values == ep.sort(dim=-1).values
                           ).all(dim=-1).float().mean()))
            for k, e in errs.items():
                worst[k] = max(worst[k], e)
            if max(errs.values()) > tol:
                fail(f"{what} layer {i}: the kernel path differs from the "
                     f"plain path by {json.dumps(errs)} > {tol}")
            x = yp
    return worst


def moe_full_phase(torch, cfg=None, device="cuda", B=4, S=2048,
                   n_decode=32, seed=7):
    """qwen3-moe-30b-a3b at full width and depth (48 layers, 128 experts,
    top-8) in bf16: weights drawn on the card in bf16, every attention
    layer scaled to its true fan-in, B=4 S=2048 prefill and 32 decode steps
    through the serve steps, then every layer through both routes."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import init_params
    cfg = (cfg or get_config("qwen3-moe-30b-a3b")).replace(
        dtype="bfloat16", use_pallas=True)
    t0 = time.perf_counter()
    params = init_params(seed, M.model_param_specs(cfg),
                         dtype=torch.bfloat16, device=device)
    condition_attention(params)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            device=device, dtype=torch.int32)
    sync(torch, device)
    n_layers = sum(g.repeat * len(g.layers) for g in cfg.groups)
    log(f"[moe] {cfg.name}: {M.count_params(cfg)} params "
        f"({M.count_params(cfg, active_only=True)} active) drawn in bf16 in "
        f"{time.perf_counter() - t0:.1f}s; {n_layers} layers, attention "
        f"scaled to its true fan-in")
    run = serve_run(torch, cfg, params, {"tokens": prompts}, n_decode, 0,
                    n_layers if device == "cuda" else 0, device, "moe",
                    MOE_RANGES)
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pos = torch.broadcast_to(torch.arange(S, device=device), (B, S))
    (g,) = cfg.groups
    (ls,) = g.layers
    gp = params["decoder"]["g0"]

    def layer(r):
        def make(x):
            if x is None:
                x = L.embed_tokens(params["embed"], prompts, cfg)
            return (ls, M._index_tree(gp, r)["L0"], x, pos, "prefill", True,
                    None)
        return make
    worst = layerwise_check(torch, cfg, [layer(r) for r in range(g.repeat)],
                            2e-2, device, "moe")
    log(f"[moe] bf16 prefill, layer by layer on the plain route's input: "
        f"kernels vs plain torch paths worst {json.dumps(worst)} (every "
        f"token held to 2e-2 of the plain path's max, the MoE on the plain "
        f"route's experts) in {time.perf_counter() - t0:.1f}s")
    run["layers"] = worst
    del params
    return run


def encdec_full_phase(torch, cfg=None, device="cuda", B=4, S_src=2048,
                      S=512, n_decode=32, seed=7):
    """seamless-m4t-medium whole in bf16: B=4, 2048 encoder frames, a
    512-token target prompt, 32 decode steps through the serve steps
    (flash in the 12 encoder layers), then every encoder and decoder layer
    through both routes."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import init_params
    cfg = (cfg or get_config("seamless-m4t-medium")).replace(
        dtype="bfloat16", use_pallas=True)
    params = init_params(seed, M.model_param_specs(cfg),
                         dtype=torch.bfloat16, device=device)
    condition_attention(params)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            device=device, dtype=torch.int32)
    frames = torch.randn((B, S_src, cfg.d_model), generator=gen,
                         device=device).to(torch.bfloat16)
    n_enc = sum(g.repeat * len(g.layers) for g in cfg.encoder_groups)
    run = serve_run(torch, cfg, params, {"tokens": prompts,
                                         "enc_embeds": frames},
                    n_decode, S_src, n_enc if device == "cuda" else 0,
                    device, "encdec", CROSS_RANGES)
    t0 = time.perf_counter()
    (ge,), (gd,) = cfg.encoder_groups, cfg.groups
    (le,), (ld,) = ge.layers, gd.layers
    enc_pos = torch.broadcast_to(torch.arange(S_src, device=device),
                                 (B, S_src))
    dec_pos = torch.broadcast_to(torch.arange(S, device=device), (B, S))
    enc_out = []

    def enc_layer(r):
        def make(x):
            x = frames if x is None else x
            return (le, M._index_tree(params["encoder"]["g0"], r)["L0"], x,
                    enc_pos, "train", False, None)
        return make

    def dec_layer(r):
        def make(x):
            if not enc_out:
                enc_out.append(L.rms_norm(x, params["encoder"]["enc_norm"],
                                          cfg.norm_eps))
                x = None
            if x is None:
                x = L.embed_tokens(params["embed"], prompts, cfg)
            p = M._index_tree(params["decoder"]["g0"], r)["L0"]
            return (ld, p, x, dec_pos, "prefill", True,
                    attn_lib.encode_cross_kv(p["cross"], enc_out[0], cfg))
        return make
    worst = layerwise_check(
        torch, cfg, [enc_layer(r) for r in range(ge.repeat)]
        + [dec_layer(r) for r in range(gd.repeat)], 2e-2, device, "encdec")
    log(f"[encdec] bf16 prefill, layer by layer on the plain route's input "
        f"({ge.repeat} encoder, then {gd.repeat} decoder layers on the plain "
        f"encoder's output): kernels vs plain torch paths worst "
        f"{json.dumps(worst)} "
        f"(tolerance 2e-2) in {time.perf_counter() - t0:.1f}s")
    run["layers"] = worst
    del params
    return run


def moe_encdec_phases(torch, device="cuda"):
    """The MoE and enc-dec slice on the card, each phase after an empty
    cache and freeing its weights: the 2-layer f32 qwen3-moe against its
    reference file, then its engine; the full-depth bf16 qwen3-moe; f32
    seamless against its reference file; bf16 seamless.  Returns the
    bf16 runs' `flash_fwd` launches by model."""
    t0 = time.perf_counter()
    cfg, params = moe_reference_phase(torch, device)
    engine_phase(torch, params, cfg, device=device)
    del params
    torch.cuda.empty_cache()
    log(f"[time] MoE reference and engine phases "
        f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    moe = moe_full_phase(torch, device=device)
    torch.cuda.empty_cache()
    log(f"[time] MoE full-depth phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    encdec_reference_phase(torch, device)
    torch.cuda.empty_cache()
    encdec = encdec_full_phase(torch, device=device)
    torch.cuda.empty_cache()
    log(f"[time] enc-dec phases {time.perf_counter() - t0:.1f}s")
    return {"moe": moe["launches"], "encdec": encdec["launches"]}



# ============= the mesh slice: serving over a (data, model) mesh ========= #
MESH_FILE = SRC / "repro_torch" / "reference_serve_mesh.json"


def mesh_rank(rank, world, init_file, backend, device, job, results):
    """One rank of `mesh_serve_phase` (a spawned process): see there.
    Reports a dict of its readings, or its traceback, on ``results``."""
    import traceback
    try:
        results.put((rank, "ok", _mesh_rank(rank, world, init_file, backend,
                                            device, job)))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))


def _mesh_serve(torch, cfg, params, mesh, prompts, n_decode, device,
                what, frames=None):
    """Prefill ``prompts`` (B, S) (and an encoder-decoder's source
    ``frames`` (B, S_src, d)) and greedy-decode ``n_decode`` steps through
    the mesh serve steps: (tokens (n+1, B), logits (n+1, B, V) f32,
    prefill s, decode ms/step, the kernels' launches)."""
    from repro_torch.models import model as M
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.sharding import infer_rules
    from repro_torch.training.train_state import (make_decode_step,
                                                  make_prefill_step)
    rules = infer_rules(cfg)
    B, S = prompts.shape
    pre = make_prefill_step(cfg, mesh, rules, return_logits=True)
    dec = make_decode_step(cfg, mesh, rules, return_logits=True)
    batch = {"tokens": prompts}
    if frames is not None:
        batch["enc_embeds"] = frames
    caches = M.init_caches(cfg, B, S + n_decode,
                           0 if frames is None else frames.shape[1],
                           mesh=mesh, rules=rules, device=device)
    C.reset_stats()
    reset_model_launches()
    sync(torch, device)
    t0 = time.perf_counter()
    tok, caches, lg = pre(params, batch, caches)
    sync(torch, device)
    prefill_s = time.perf_counter() - t0
    toks, logits = [tok], [lg.float()]
    t0 = time.perf_counter()
    for _ in range(n_decode):
        tok, caches, lg = dec(params, {"tokens": tok[:, None]}, caches)
        toks.append(tok)
        logits.append(lg.float())
    sync(torch, device)
    decode_ms = (time.perf_counter() - t0) * 1e3 / max(n_decode, 1)
    return {"what": what, "tokens": torch.stack(toks),
            "logits": torch.stack(logits), "prefill_s": prefill_s,
            "decode_ms": decode_ms, "launches": model_launches(),
            "wire": dict(C.STATS)}


def _single_logits(torch, cfg, params, prompts, toks, device):
    """The single-device port's logits (n+1, B, V) f32 of a prefill and
    decode steps teacher-forced with ``toks`` (n+1, B)."""
    from repro_torch.models import model as M
    B, S = prompts.shape
    n = toks.shape[0] - 1
    caches = M.init_caches(cfg, B, S + n, device=device)
    out = []
    with torch.no_grad():
        lg, caches = M.prefill(cfg, params, {"tokens": prompts}, caches)
        out.append(lg.float())
        for i in range(n):
            lg, caches = M.decode_step(cfg, params,
                                       {"tokens": toks[i][:, None]}, caches)
            out.append(lg.float())
    return torch.stack(out)


def _mesh_layerwise(torch, cfg, full, local, mesh, prompts):
    """Each layer of a prefill on the same input (the single-device run's
    input to that layer) through the single-device layer (``full``) and
    through its mesh blocks (``local``, this rank's rows): the worst max
    |mesh - single| over max |single| of each layer's output."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding as shlib
    from repro_torch.parallel.collectives import all_gather, local_chunk
    rules = shlib.infer_rules(cfg)
    B, S = prompts.shape
    axes = shlib.entry_axes(shlib.logical_to_mesh_axes(mesh, (B,),
                                                       ("batch",), rules)[0])
    pos = torch.broadcast_to(torch.arange(S, device=prompts.device), (B, S))
    aux = torch.zeros((), device=prompts.device)
    out = []
    with torch.no_grad():
        x = L.embed_tokens(full["embed"], prompts, cfg)
        for gi, g in enumerate(cfg.groups):
            for r in range(g.repeat):
                pf = M._index_tree(full["decoder"][f"g{gi}"], r)
                pl = M._index_tree(local["decoder"][f"g{gi}"], r)
                for i, ls in enumerate(g.layers):
                    y1, _, _ = M.apply_layer(
                        cfg, ls, pf[f"L{i}"], x, aux, mode="prefill",
                        shared_params=full.get("shared_attn"),
                        positions=pos)
                    with shlib.sharding_ctx(mesh, rules, batch=B,
                                            cache_len=S):
                        y2, _, _ = M.apply_layer(
                            cfg, ls, pl[f"L{i}"],
                            local_chunk(x, axes, mesh, 0), aux,
                            mode="prefill",
                            shared_params=local.get("shared_attn"),
                            positions=local_chunk(pos, axes, mesh, 0))
                        y2 = all_gather(y2, axes, mesh)
                    out.append(float((y2.float() - y1.float()).abs().max()
                                     / y1.float().abs().max()))
                    x = y1
    return out


def _mesh_encdec_layerwise(torch, cfg, full, local, mesh, prompts, frames):
    """`_mesh_layerwise` for an encoder-decoder: each encoder layer on the
    single-device run's input to it, then each decoder layer (prefill,
    its cross k/v from the single-device encoder's output), through the
    single-device layer and its mesh blocks on this rank's rows."""
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding as shlib
    from repro_torch.parallel.collectives import all_gather, local_chunk
    rules = shlib.infer_rules(cfg)
    B, S = prompts.shape
    S_src = frames.shape[1]
    axes = shlib.entry_axes(shlib.logical_to_mesh_axes(mesh, (B,),
                                                       ("batch",), rules)[0])
    rows = lambda t: local_chunk(t, axes, mesh, 0)  # noqa: E731
    aux = torch.zeros((), device=prompts.device)
    out = []

    def layers(groups, tree):
        for gi, g in enumerate(groups):
            for r in range(g.repeat):
                pf = M._index_tree(full[tree][f"g{gi}"], r)
                pl = M._index_tree(local[tree][f"g{gi}"], r)
                for i, ls in enumerate(g.layers):
                    yield ls, pf[f"L{i}"], pl[f"L{i}"]
    with torch.no_grad():
        x = frames
        pos = torch.broadcast_to(torch.arange(S_src, device=x.device),
                                 (B, S_src))
        for ls, pf, pl in layers(cfg.encoder_groups, "encoder"):
            y1, _, _ = M.apply_layer(cfg, ls, pf, x, aux, mode="train",
                                     positions=pos, causal=False)
            with shlib.sharding_ctx(mesh, rules, batch=B, seq=S_src):
                y2, _, _ = M.apply_layer(cfg, ls, pl, rows(x), aux,
                                         mode="train", positions=rows(pos),
                                         causal=False)
                y2 = all_gather(y2, axes, mesh)
            out.append(float((y2.float() - y1.float()).abs().max()
                             / y1.float().abs().max()))
            x = y1
        enc = L.rms_norm(x, full["encoder"]["enc_norm"], cfg.norm_eps)
        x = L.embed_tokens(full["embed"], prompts, cfg)
        pos = torch.broadcast_to(torch.arange(S, device=x.device), (B, S))
        for ls, pf, pl in layers(cfg.groups, "decoder"):
            y1, _, _ = M.apply_layer(
                cfg, ls, pf, x, aux, mode="prefill", positions=pos,
                enc_kv=A.encode_cross_kv(pf["cross"], enc, cfg))
            with shlib.sharding_ctx(mesh, rules, batch=B, seq=S,
                                    cache_len=S):
                y2, _, _ = M.apply_layer(
                    cfg, ls, pl, rows(x), aux, mode="prefill",
                    positions=rows(pos),
                    enc_kv=A.encode_cross_kv(pl["cross"], rows(enc), cfg))
                y2 = all_gather(y2, axes, mesh)
            out.append(float((y2.float() - y1.float()).abs().max()
                             / y1.float().abs().max()))
            x = y1
    return out


def _mesh_kernels(torch, device):
    """`flash_fwd` and `ssd_scan` at a (2, 2) rank's local-head shapes on
    this rank, against their plain versions: (name, case, max abs err)."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssd import kernel as ssk
    g = torch.Generator(device=device).manual_seed(7)

    def up(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=device) * scale).to(
            torch.bfloat16)
    out = []
    for Hq, Hkv, D in ((16, 16, 112), (16, 2, 128)):
        q, k, v = up(2, 2048, Hq, D), up(2, 2048, Hkv, D), up(2, 2048, Hkv, D)
        got, _ = fk.flash_fwd(q, k, v, causal=True)
        want, _ = fk.flash_fwd_plain(q, k, v, causal=True)
        out.append(("flash_fwd", f"B=2 Hq={Hq} Hkv={Hkv} D={D}",
                    float((got.float() - want.float()).abs().max()), 2e-2))
    x = up(2, 2048, 56, 64)
    dt = torch.nn.functional.softplus(torch.randn(
        (2, 2048, 56), generator=g, device=device))
    A = -torch.exp(torch.randn((56,), generator=g, device=device) * 0.3)
    Bm, Cm = up(2, 2048, 1, 64, scale=0.5), up(2, 2048, 1, 64, scale=0.5)
    y, _ = ssk.ssd_scan(x, dt, A, Bm, Cm, chunk=256)
    wy, _ = ssk.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=256)
    err = float((y.float() - wy.float()).abs().max())
    out.append(("ssd_scan", "B=2 H=56 P=64 N=64 chunk=256", err,
                1e-2 * float(wy.float().abs().max())))
    return out


def _file_check(torch, ref, got, what):
    """A mesh run's tokens and logits against a reference file's steps:
    tokens equal, logits at the file's indices within its tolerance of
    max|logit|.  Returns the worst error."""
    import numpy as np
    idx = torch.tensor(ref["logit_index"], device=got["logits"].device)
    worst = 0.0
    for i, step in enumerate(ref["steps"]):
        want_t = step["tokens"] if "tokens" in step else [step["token"]]
        lg = got["logits"][i]
        if got["tokens"][i].tolist() != want_t:
            raise AssertionError(f"{what} step {i}: tokens "
                                 f"{got['tokens'][i].tolist()}, the file's "
                                 f"{want_t}")
        values = np.asarray(step["values"]).reshape(len(want_t), -1)
        max_abs = np.asarray(step["max_abs"]).reshape(-1)
        err = np.abs(lg[:, idx].cpu().numpy() - values).max(axis=1)
        rel = float((np.maximum(err, np.abs(lg.abs().amax(-1).cpu().numpy()
                                            - max_abs)) / max_abs).max())
        worst = max(worst, rel)
        if rel > ref["tolerance"]:
            raise AssertionError(f"{what} step {i}: logits off by {rel:.3e} "
                                 f"of max|logit|")
    return worst


def _mesh_rank(rank, world, init_file, backend, device, job):
    import datetime
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.convert import shard_params
    from repro_torch.parallel.sharding import (infer_rules, init_params,
                                               init_params_numpy)
    on_card = device == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(rank if backend == "nccl" else 0)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=900))
    out = {"rank": rank, "runs": {}}
    try:
        if on_card and job.get("kernels"):
            out["kernels"] = _mesh_kernels(torch, device)
        meshes = {shape: make_host_mesh(*shape) for shape in job["meshes"]}

        def keep(got):
            got = dict(got)
            if on_card:
                got["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            out["runs"][got["what"]] = got
            return got

        # ---- zamba2 at full width, 13 layers, bf16, on (2, 2) ----------- #
        z = job.get("zamba2")
        if z:
            cfg = z["cfg"]
            full = condition_attention(init_params(
                z["seed"], M.model_param_specs(cfg), dtype=torch.bfloat16,
                device=device))
            params = shard_params(full, M.model_param_specs(cfg),
                                  meshes[z["mesh"]], infer_rules(cfg),
                                  device=device)
            if on_card:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            g = torch.Generator().manual_seed(z["seed"])
            prompts = torch.randint(0, cfg.vocab_size, (z["B"], z["S"]),
                                    generator=g, dtype=torch.int32).to(device)
            got = keep(_mesh_serve(torch, cfg, params, meshes[z["mesh"]],
                                   prompts, z["n_decode"], device,
                                   "zamba2_bf16"))
            got["layers"] = _mesh_layerwise(torch, cfg, full, params,
                                            meshes[z["mesh"]], prompts)
            del params
            dist.barrier()
            if rank == 0:
                single = _single_logits(torch, cfg, full, prompts,
                                        got["tokens"], device)
                diff = (got["logits"] - single).abs().amax(dim=(1, 2))
                scale = single.abs().amax(dim=(1, 2))
                got["vs_single"] = float((diff / scale).max())
                got["tokens_agree"] = float(
                    (single.argmax(-1) == got["tokens"]).float().mean())
                del full, single
            dist.barrier()
            if on_card:
                torch.cuda.empty_cache()

        # ---- the 7-layer f32 zamba2 of reference_serve.json ------------- #
        r = job.get("serve_ref")
        if r:
            ref, cfg = r["ref"], r["cfg"]
            tree = init_params_numpy(ref["seed"], M.model_param_specs(cfg))
            prompt = torch.tensor([ref["prompt"]], dtype=torch.int32,
                                  device=device)
            for shape in r["meshes"]:
                params = shard_params(tree, M.model_param_specs(cfg),
                                      meshes[shape], infer_rules(cfg),
                                      device=device)
                got = keep(_mesh_serve(torch, cfg, params, meshes[shape],
                                       prompt, ref["decode_steps"], device,
                                       f"serve_ref_{shape[0]}x{shape[1]}"))
                got["worst"] = _file_check(torch, ref, got, got["what"])
                del params
            # the sharded engine against the single-device engine
            e = r.get("engine")
            if e:
                from repro_torch.serving.engine import (ServeConfig,
                                                        ServingEngine)
                mesh = meshes[e["mesh"]]
                prompts = [np.asarray(p, np.int32) for p in e["prompts"]]
                sc = ServeConfig(slots=e["slots"], max_len=e["max_len"])

                def drain(eng):
                    for p in prompts:
                        eng.submit(p, max_new=e["max_new"])
                    reqs = list(eng.queue)
                    t0 = time.perf_counter()
                    while eng.queue or eng.active:
                        eng.step()
                    sync(torch, device)
                    return ([q.out_tokens for q in reqs],
                            time.perf_counter() - t0)
                reset_model_launches()
                tokens, secs = drain(ServingEngine(cfg, tree, sc, mesh=mesh,
                                                   device=device))
                out["engine"] = {"tokens": tokens, "s": secs,
                                 "launches": model_launches()}
                if rank == 0:
                    from repro_torch.models.convert import \
                        params_from_reference
                    single, s1 = drain(ServingEngine(
                        cfg, params_from_reference(tree, device=device), sc,
                        device=device))
                    out["engine"].update(single=single, single_s=s1)
                dist.barrier()
            del tree

        # ---- qwen3-moe at full width, 4 layers, bf16, on (2, 2) --------- #
        q = job.get("moe")
        if q:
            cfg = q["cfg"]
            full = condition_attention(init_params(
                q["seed"], M.model_param_specs(cfg), dtype=torch.bfloat16,
                device=device))
            params = shard_params(full, M.model_param_specs(cfg),
                                  meshes[q["mesh"]], infer_rules(cfg),
                                  device=device)
            del full
            if on_card:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            g = torch.Generator().manual_seed(q["seed"])
            prompts = torch.randint(0, cfg.vocab_size, (q["B"], q["S"]),
                                    generator=g, dtype=torch.int32).to(device)
            moe_lib.DISPATCH.clear()
            got = keep(_mesh_serve(torch, cfg, params, meshes[q["mesh"]],
                                   prompts, q["n_decode"], device,
                                   "moe_bf16"))
            got["dispatch"] = dict(moe_lib.DISPATCH)
            got["finite"] = bool(torch.isfinite(got["logits"]).all())
            del params
            if on_card:
                torch.cuda.empty_cache()

        # ---- the 2-layer f32 qwen3-moe of reference_serve_mesh.json ----- #
        m = job.get("moe_ref")
        if m:
            ref, cfg = m["ref"], m["cfg"]
            mesh = meshes[tuple(ref["mesh"])]
            tree = init_params_numpy(ref["seed"], M.model_param_specs(cfg))
            params = shard_params(tree, M.model_param_specs(cfg), mesh,
                                  infer_rules(cfg), device=device)
            del tree
            calls, caps = [], []
            inner, inner_cap = moe_lib._route, moe_lib.local_capacity

            def route(xf, w, k):
                res = inner(xf, w, k)
                calls.append(res[1].cpu().numpy())
                return res

            def capacity(c, n):
                caps.append(inner_cap(c, n))
                return caps[-1]
            moe_lib._route, moe_lib.local_capacity = route, capacity
            try:
                got = keep(_mesh_serve(
                    torch, cfg, params, mesh,
                    torch.tensor(ref["prompts"], dtype=torch.int32,
                                 device=device), ref["decode_steps"], device,
                    "moe_ref"))
            finally:
                moe_lib._route, moe_lib.local_capacity = inner, inner_cap
            got["worst"] = _file_check(torch, ref, got, "moe_ref")
            routing = []
            for e_, cap in zip(calls, caps):
                counts = np.bincount(e_.reshape(-1),
                                     minlength=cfg.num_experts)
                routing.append([int(e_.shape[0]), int(cap), counts.tolist(),
                                int(np.maximum(counts - cap, 0).sum())])
            d, mm = mesh.get_coordinate()
            if routing != ref["routing"][f"{d},{mm}"]:
                raise AssertionError(f"moe_ref: shard ({d}, {mm}) routing "
                                     "differs from the file's")
            got["drops"] = [c[3] for c in routing]
            del params

        # ---- seamless-m4t-medium whole, bf16, on (2, 2) ----------------- #
        e = job.get("encdec")
        if e:
            cfg = e["cfg"]
            mesh = meshes[e["mesh"]]
            full = condition_attention(init_params(
                e["seed"], M.model_param_specs(cfg), dtype=torch.bfloat16,
                device=device))
            params = shard_params(full, M.model_param_specs(cfg), mesh,
                                  infer_rules(cfg), device=device)
            if on_card:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            g = torch.Generator().manual_seed(e["seed"])
            prompts = torch.randint(0, cfg.vocab_size, (e["B"], e["S"]),
                                    generator=g, dtype=torch.int32).to(device)
            frames = torch.randn((e["B"], e["S_src"], cfg.d_model),
                                 generator=g).to(device, torch.bfloat16)
            got = keep(_mesh_serve(torch, cfg, params, mesh, prompts,
                                   e["n_decode"], device, "encdec_bf16",
                                   frames))
            got["finite"] = bool(torch.isfinite(got["logits"]).all())
            got["layers"] = _mesh_encdec_layerwise(torch, cfg, full, params,
                                                   mesh, prompts, frames)
            del params, full
            if on_card:
                torch.cuda.empty_cache()

        # ---- seamless f32 of reference_serve_encdec.json on (2, 2) ------ #
        er = job.get("encdec_ref")
        if er:
            from repro_torch.models.convert import params_from_reference
            ref, cfg = er["ref"], er["cfg"]
            mesh = meshes[tuple(er["mesh"])]
            specs = M.model_param_specs(cfg)
            full = params_from_reference(init_params_numpy(ref["seed"],
                                                           specs),
                                         specs, device=device)
            if ref.get("attention_scaled"):
                condition_attention(full)
            params = shard_params(full, specs, mesh, infer_rules(cfg),
                                  device=device)
            del full
            if on_card:
                torch.cuda.empty_cache()
            rng = np.random.default_rng(ref["seed"])
            prompt = rng.integers(0, cfg.vocab_size,
                                  (1, len(ref["prompt"])))
            rng.choice(cfg.vocab_size, len(ref["logit_index"]),
                       replace=False)
            frames = rng.standard_normal((1, ref["src_len"], cfg.d_model),
                                         dtype=np.float32)
            if prompt[0].tolist() != ref["prompt"]:
                raise AssertionError("encdec_ref: the prompt drawn here "
                                     "differs from the file's")
            got = keep(_mesh_serve(
                torch, cfg, params, mesh,
                torch.tensor(prompt, dtype=torch.int32, device=device),
                ref["decode_steps"], device, "encdec_ref",
                torch.from_numpy(frames).to(device)))
            got["worst"] = _file_check(torch, ref, got, "encdec_ref")
            del params
        for got in out["runs"].values():
            got["tokens"] = got["tokens"].tolist()
            got.pop("logits")
        return out
    finally:
        dist.destroy_process_group()


def spawn_mesh_ranks(world, root, backend, device, job, limit,
                     target=None):
    """``world`` spawned ``target`` processes (`mesh_rank` by default) on
    one process group; their readings in rank order.  Fails, after
    killing every rank, when a rank raises, dies or they outlast
    ``limit`` seconds."""
    import multiprocessing
    import queue
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init_file = Path(root) / f"pg_mesh_{backend}"
    Path(root).mkdir(parents=True, exist_ok=True)
    init_file.unlink(missing_ok=True)
    procs = [ctx.Process(target=target or mesh_rank, daemon=True,
                         args=(r, world, str(init_file), backend, device,
                               job, results))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + limit
    got, errors = {}, []
    try:
        while len(got) < world and not errors:
            try:
                rank, status, out = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if dead:
                    errors.append(f"ranks {dead} exited without a result")
                elif time.monotonic() > deadline:
                    errors.append(f"the ranks outlasted {limit} s")
                continue
            if status == "error":
                errors.append(f"rank {rank}:\n{out}")
            got[rank] = out
        for p in procs if not errors else ():
            p.join(timeout=max(0.0, deadline - time.monotonic()) + 10.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    if errors:
        fail(f"mesh ranks ({backend}): " + "\n".join(errors))
    return [got[r] for r in range(world)]


def mesh_jobs(zamba2=None, moe=None, serve_ref=True, moe_ref=True,
              encdec=None, encdec_ref=True):
    """The mesh phase's job for 4 ranks sharing one card: the configs of
    each run (``zamba2`` / ``moe`` / ``encdec`` replace the full-width
    ones, for a rehearsal on the CPU; ``serve_ref`` / ``moe_ref`` /
    ``encdec_ref`` take the reference files' full-width f32 models)."""
    from repro_torch.configs.base import GroupSpec, LayerSpec, get_config
    job = {"meshes": [(2, 2), (1, 4)], "kernels": True}
    job["zamba2"] = {"cfg": zamba2 or get_config("zamba2-7b").replace(
        dtype="bfloat16", use_pallas=True, groups=train_groups()),
        "seed": 20, "mesh": (2, 2), "B": 4, "S": 2048, "n_decode": 16}
    moe_groups = (GroupSpec((LayerSpec("attn", "moe"),), 4),)
    job["moe"] = {"cfg": moe or get_config("qwen3-moe-30b-a3b").replace(
        dtype="bfloat16", use_pallas=True, groups=moe_groups),
        "seed": 20, "mesh": (2, 2), "B": 4, "S": 2048, "n_decode": 2}
    if serve_ref:
        ref = json.loads(SERVE_FILE.read_text())
        job["serve_ref"] = {
            "ref": ref, "cfg": serve_reference_config(ref),
            "meshes": [(2, 2), (1, 4)],
            "engine": {"mesh": (2, 2), "slots": 2, "max_len": 64,
                       "max_new": 8, "prompts": [
                           ref["prompt"][i:i + n] for i, n in
                           ((0, 12), (100, 5), (300, 20), (700, 9))]}}
    if moe_ref:
        ref = json.loads(MESH_FILE.read_text())
        job["moe_ref"] = {"ref": ref, "cfg": serve_reference_config(ref)}
    job["encdec"] = {"cfg": encdec or get_config(
        "seamless-m4t-medium").replace(dtype="bfloat16", use_pallas=True),
        "seed": 20, "mesh": (2, 2), "B": 4, "S_src": 2048, "S": 512,
        "n_decode": 4}
    if encdec_ref:
        ref = json.loads(ENCDEC_FILE.read_text())
        job["encdec_ref"] = {"ref": ref, "cfg": serve_reference_config(ref),
                             "mesh": (2, 2)}
    return job


def mesh_serve_phase(torch, job=None, device="cuda", limit=600.0):
    """Serving over a (data, model) mesh: 4 spawned gloo ranks share the
    card (NCCL refuses two ranks on one card): the compute and the
    kernels stay on the card, the collectives cross the host
    (`parallel.collectives`, a counted hop).  Every rank holds
    `flash_fwd` and `ssd_scan` against their plain versions at its
    local-head shapes, then (`mesh_jobs`):
    - zamba2-7b at full width cut to 13 layers (the train cut: 2
      shared-attention hits), bf16, B=4 S=2048 prefill + 16 decode steps
      on a (2, 2) mesh; each layer on the same input within 2e-2 of its
      max of the port's single-device layer on the same weights (the
      serve slice's bf16 layer bound), and the whole model's logits
      (teacher-forced) and greedy tokens against the single-device run
      reported;
    - the 7-layer f32 zamba2 of `reference_serve.json` on the (2, 2) mesh
      (B=1: the caches' sequence over both axes) and a (1, 4) mesh, its
      tokens the file's and its logits within the file's tolerance; the
      sharded `ServingEngine` on 4 requests equal to the single-device
      engine;
    - qwen3-moe-30b-a3b at full width cut to 4 layers, bf16, B=4 S=2048
      + 2 decode steps on (2, 2): a2a dispatch in prefill, replicated in
      decode (experts FSDP over data, gathered a layer at a time);
    - the 2-layer f32 qwen3-moe of `reference_serve_mesh.json`: tokens,
      logits, and every shard's expert counts and drops the file's.
    Prints each rank's prefill s, decode ms/step, wire bytes and calls,
    peak memory and launches.  With two cards or more, the f32 zamba2
    also runs on a (1, 2) NCCL mesh, one card a rank.  Returns rank 0's
    launches over its bf16 runs."""
    root = ROOT / "build" / "chip_mesh"
    job = job or mesh_jobs()
    t0 = time.perf_counter()
    outs = spawn_mesh_ranks(4, root, "gloo", device, job, limit)
    wall = time.perf_counter() - t0
    for o in outs:
        r = o["rank"]
        for name, case, err, tol in o.get("kernels", []):
            log(f"[mesh] rank {r} {name} {case} bf16 against its plain "
                f"version: max abs err {err:.3e} (tolerance {tol:.3g})")
            if not err <= tol:
                fail(f"mesh rank {r}: {name} {case} off by {err:.3e}")
        for name, got in o["runs"].items():
            w = got["wire"]
            log(f"[mesh] rank {r} {name}: prefill {got['prefill_s']:.3f}s, "
                f"decode {got['decode_ms']:.2f} ms/step; wire "
                f"{w.get('wire_bytes', 0)} bytes in "
                f"{sum(v for k, v in w.items() if k in COLLECTIVES)} calls "
                f"({json.dumps({k: v for k, v in w.items() if k in COLLECTIVES})}"
                f"), host hop {w.get('hop_bytes', 0)} bytes, "
                f"{w.get('seconds', 0):.3f}s in collectives; peak "
                f"{got.get('peak_gib', 0):.2f} GiB; launches "
                f"{json.dumps(got['launches'])} ({card_or_cpu(device)})")
    o0 = outs[0]
    runs = o0["runs"]
    for name in runs:
        if any(o["runs"][name]["tokens"] != runs[name]["tokens"]
               for o in outs):
            fail(f"mesh {name}: the ranks returned different tokens")
    z = runs.get("zamba2_bf16")
    if z:
        n_ssd, n_attn = layer_counts(job["zamba2"]["cfg"])
        n_dec = job["zamba2"]["n_decode"]
        want = (route_counts(n_attn, n_ssd, n_attn, n_ssd)
                if device == "cuda" else route_counts(0, 0, 0, 0))
        if z["launches"] != want:
            fail(f"mesh zamba2 launched {z['launches']}, expected {want}")
        worst = max(max(o["runs"]["zamba2_bf16"]["layers"]) for o in outs)
        log(f"[mesh] zamba2 bf16 (2, 2) against the single-device run on "
            f"the same weights: each layer on the same input within "
            f"{worst:.3e} of its max (layers "
            f"{[round(v, 5) for v in z['layers']]}); the whole model's "
            f"logits within {z['vs_single']:.3e} of max|logit| (prefill + "
            f"{n_dec} teacher-forced steps), greedy tokens agree "
            f"{z['tokens_agree']:.3f}")
        if not worst <= 2e-2:
            fail(f"a mesh zamba2 bf16 layer differs from one device by "
                 f"{worst:.3e} of its max")
        # the whole model is held in f32 (the reference_serve.json runs
        # below); in bf16 a random stack amplifies one rounding
        # difference layer by layer, so its end to end is a reading
    c = runs.get("encdec_bf16")
    if c:
        n_enc = sum(g.repeat * len(g.layers)
                    for g in job["encdec"]["cfg"].encoder_groups)
        want = (route_counts(n_enc, 0, n_enc, 0) if device == "cuda"
                else route_counts(0, 0, 0, 0))
        worst = max(max(o["runs"]["encdec_bf16"]["layers"]) for o in outs)
        log(f"[mesh] seamless bf16 (2, 2), B={job['encdec']['B']} "
            f"{job['encdec']['S_src']} frames, {job['encdec']['S']} target "
            f"tokens, {job['encdec']['n_decode']} decode steps: each layer "
            f"on the same input within {worst:.3e} of the single-device "
            f"layer's max (encoder, then decoder: "
            f"{[round(v, 5) for v in c['layers']]}); launches "
            f"{json.dumps(c['launches'])}")
        if c["launches"] != want or not c["finite"]:
            fail(f"mesh seamless launched {c['launches']} (expected {want}),"
                 f" finite logits {c['finite']}")
        if not worst <= 2e-2:
            fail(f"a mesh seamless bf16 layer differs from one device by "
                 f"{worst:.3e} of its max")
    for name in ("serve_ref_2x2", "serve_ref_1x4", "moe_ref", "encdec_ref"):
        if name in runs:
            log(f"[mesh] {name} equals its reference file on every rank "
                f"(worst {max(o['runs'][name]['worst'] for o in outs):.3e} "
                f"of max|logit|)"
                + (f"; drops per MoE call {[o['runs'][name]['drops'] for o in outs]}"
                   if name == "moe_ref" else ""))
    if "engine" in o0:
        e = o0["engine"]
        if any(o["engine"]["tokens"] != e["single"] for o in outs):
            fail(f"the sharded engine served {e['tokens']}, one device "
                 f"{e['single']}")
        log(f"[mesh] sharded engine (2, 2): {len(e['tokens'])} requests "
            f"equal the single-device engine's in {e['s']:.2f}s (one "
            f"device {e['single_s']:.2f}s); launches "
            f"{json.dumps(e['launches'])}")
    q = runs.get("moe_bf16")
    if q:
        n_layers = sum(g.repeat for g in job["moe"]["cfg"].groups)
        n_dec = job["moe"]["n_decode"]
        want = {"a2a": n_layers, "replicated": n_layers * n_dec}
        if q["dispatch"] != want or not q["finite"]:
            fail(f"mesh qwen3-moe dispatched {q['dispatch']} (expected "
                 f"{want}), finite logits {q['finite']}")
        if device == "cuda" and \
                q["launches"]["flash_fwd.wgmma"] != n_layers:
            fail(f"mesh qwen3-moe launched {q['launches']}")
    log(f"[mesh] 4 gloo ranks on one card: wall {wall:.1f}s "
        f"({card_or_cpu(device)})")
    n_cards = torch.cuda.device_count() if device == "cuda" else 0
    if n_cards >= 2 and "serve_ref" in job:
        nccl_job = {"meshes": [(1, 2)], "serve_ref": dict(
            job["serve_ref"], meshes=[(1, 2)], engine=None)}
        nc = spawn_mesh_ranks(2, root, "nccl", device, nccl_job, limit)
        got = nc[0]["runs"]["serve_ref_1x2"]
        log(f"[mesh] NCCL (1, 2), one card a rank: reference_serve.json "
            f"equal (worst {got['worst']:.3e}), prefill "
            f"{got['prefill_s']:.3f}s, decode {got['decode_ms']:.2f} "
            f"ms/step ({card()})")
    else:
        log(f"[mesh] the NCCL mesh did not run: {n_cards} card(s), and "
            "NCCL refuses two ranks on one card")
    return {"zamba2": (z or {}).get("launches", {}),
            "moe": (q or {}).get("launches", {}),
            "encdec": (c or {}).get("launches", {})}


COLLECTIVES = ("psum", "pmax", "all_gather", "all_to_all", "psum_scatter")


# ================= training over a (data, model) mesh ===================== #
MESH_TRAIN_SEED = 31
# qwen3-moe's depth for the one-device train step: 4 layers hold
# 3,114,814,464 params (4 x 623M + the 311M embedding and 311M head); at
# 18 bytes a parameter (the f32 master, m, v and gradient, and the bf16
# copy) that is 52.2 GiB, and with ~6 GiB of activations and temporaries
# it stays under 75 GiB of the card's 80 GB (a step's peak read 61.7
# GiB on an H100 80GB HBM3 at 700 W)
MOE_SINGLE_LAYERS = 4
# phase d: the int8 all-to-all's gradients against the exact ones, the
# worst leaf's relative L2 over the whole leaf.  A sound run reads 0.112
# (layer 0's router: the int8 noise flips near-tied top-8 choices of the
# random router downstream); with the dequant scale 5% off it reads
# 0.465 while the loss stays within 3.8e-4 of exact (H100 80GB HBM3,
# 700 W)
INT8_GRAD_REL = 0.25


def mesh_train_jobs(f32=None, bf16=None, moe=None, moe_single=None, B=2,
                    S=2048):
    """The mesh-train phase's job (``f32`` / ``bf16`` / ``moe`` /
    ``moe_single`` replace the full-width configs, for a rehearsal on the
    CPU):
    a. ``f32``: zamba2-7b cut to 7 layers (one shared-attention hit),
       f32, one step on the (2, 2) mesh against one device's;
    b. ``bf16``: the 13-layer cut of the train slice (2 hits), bf16 with
       f32 masters, the layer gate and the timed steps;
    c. ``moe_single``: qwen3-moe-30b-a3b cut to `MOE_SINGLE_LAYERS`
       layers, bf16, one device;
    d. ``moe``: qwen3-moe cut to 2 layers, f32, one step with the exact
       all-to-all and one with the int8 one, on the mesh.
    All at full width, remat "full", the kernels on, B x S tokens a step
    (B rows over ``data``)."""
    from repro_torch.configs.base import GroupSpec, LayerSpec, get_config
    z = get_config("zamba2-7b")
    ssd, hit = LayerSpec("ssd", "none"), LayerSpec("ssd", "none", True)
    q = get_config("qwen3-moe-30b-a3b")

    def moe_cut(n):
        return q.replace(groups=(GroupSpec((LayerSpec("attn", "moe"),), n),))
    knobs = dict(use_pallas=True, remat="full")
    return {
        "mesh": (2, 2), "B": B, "S": S, "seed": MESH_TRAIN_SEED,
        "n_steps": 2, "kernels": True,
        "f32": (f32 or z.replace(groups=(GroupSpec((ssd,) * 5 + (hit,), 1),
                                         GroupSpec((ssd,), 1)))
                ).replace(dtype="float32", **knobs),
        "bf16": (bf16 or z.replace(groups=train_groups())).replace(
            dtype="bfloat16", **knobs),
        "moe": (moe or moe_cut(2)).replace(dtype="float32", **knobs),
        "moe_single": (moe_single or moe_cut(MOE_SINGLE_LAYERS)).replace(
            dtype="bfloat16", **knobs)}


def train_params(torch, cfg, seed, device):
    """f32 master weights drawn on ``device`` from ``seed`` (the same on
    every rank of the device), attention scaled to its true fan-in."""
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import init_params
    return condition_attention(init_params(seed, M.model_param_specs(cfg),
                                           device=device))


def train_batch(torch, cfg, B, S, seed, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                         device=device, dtype=torch.int32)
    return {"tokens": toks[:, :-1].contiguous(),
            "labels": toks[:, 1:].contiguous()}


def f32_single_step(torch, job, root, device):
    """Phase a's one-device f32 step (`loss_and_grads`, then
    `adamw_update` from zero moments: the train step's two halves),
    written to ``root``/single_f32.pt on the host, the card freed."""
    from repro_torch.optim.adamw import adamw_update
    from repro_torch.parallel.sharding import tree_leaves_with_path
    from repro_torch.training.train_state import loss_and_grads
    cfg = job["f32"]
    params = train_params(torch, cfg, job["seed"], device)
    batch = train_batch(torch, cfg, job["B"], job["S"], job["seed"], device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    sync(torch, device)
    t0 = time.perf_counter()
    met, grads = loss_and_grads(cfg, params, batch)
    opt = {k: _zeros_like(torch, params) for k in ("m", "v")}
    adamw_update(_mesh_opt(), params, grads, opt,
                 torch.zeros((), dtype=torch.int32, device=device))
    sync(torch, device)
    secs = time.perf_counter() - t0
    host = {"loss": float(met["loss"]),
            "grads": {p: g.cpu() for p, g in tree_leaves_with_path(grads)},
            "params": {p: t.cpu() for p, t in tree_leaves_with_path(params)}}
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30
            if device == "cuda" else 0.0)
    del params, grads, opt, batch
    Path(root).mkdir(parents=True, exist_ok=True)
    torch.save(host, Path(root) / "single_f32.pt")
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"loss": host["loss"], "s": secs, "peak_gib": peak}


def _mesh_opt():
    from repro_torch.optim.adamw import AdamWConfig
    return AdamWConfig(lr=1e-4, warmup_steps=1)


def layer_grads(torch, cfg, ls, p, shared, x, probe, pos, plan=None,
                shared_plan=None):
    """(y, {leaf: grad}) of one layer in train mode for the loss
    sum(y * probe): the grads of its params (``shared_attn.``-prefixed for
    the shared attention's), cast as the train step casts them, and of
    its input (``x``).  With ``plan`` (under a `sharding_ctx`) the params
    are this rank's blocks, gathered from FSDP under autograd as
    `run_groups` gathers them."""
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import tree_leaves_with_path
    leaves = {"x": x.detach().requires_grad_()}
    for pre, tree in (("", p), ("shared_attn.", shared or {})):
        for path, a in tree_leaves_with_path(tree):
            leaves[pre + path] = a.detach().requires_grad_()

    def graft(tree, pre):
        return {k: graft(v, f"{pre}{k}.") if isinstance(v, dict)
                else _cast(leaves[f"{pre}{k}"], cfg)
                for k, v in tree.items()}
    with torch.enable_grad():
        lp = graft(p, "")
        sp = graft(shared, "shared_attn.") if shared else None
        if plan is not None:
            lp = M._gather_fsdp(lp, plan)
            sp = M._gather_fsdp(sp, shared_plan) if sp else None
        y, _, _ = M.apply_layer(cfg, ls, lp, leaves["x"],
                                torch.zeros((), device=x.device),
                                shared_params=sp, mode="train",
                                positions=pos)
        gs = torch.autograd.grad((y.float() * probe).sum(),
                                 list(leaves.values()))
    return y.detach(), dict(zip(leaves, gs))


def _cast(a, cfg):
    import torch
    return (a.to(cfg.act_dtype) if a.dtype == torch.float32 and a.ndim >= 2
            else a)


def _layouts(specs, mesh, rules, strip=0):
    """path -> (param layout, TP layout, the mesh axes the block is
    replicated on) of a spec tree's leaves, the first ``strip`` dims (a
    stacked group's repeat axis) dropped, and the stacked leaves whose
    FSDP took that axis ({path: (param layout, TP layout)}, gathered
    whole before a slice is taken, as `run_groups` does; their slices
    then lie in the TP layout)."""
    from repro_torch.parallel import sharding as shlib
    names = tuple(mesh.mesh_dim_names)
    out, whole = {}, {}
    for path, s in shlib.tree_leaves_with_path(specs):
        ps = shlib.param_sharding(mesh, s, rules)
        ts = shlib.logical_to_mesh_axes(mesh, s.shape, s.logical, rules)
        if any(shlib.entry_axes(e) for e in ps[:strip]):
            whole[path] = (ps, ts)
            ps = ts
        used = {a for e in ps for a in shlib.entry_axes(e)}
        out[path] = (ps[strip:], ts[strip:],
                     tuple(a for a in names if a not in used))
    return out, whole


def mesh_layer_gate(torch, cfg, full, local, batch, mesh, rules, tol=5e-2):
    """Each layer of a bf16 model on the mesh against one device, on the
    same input (the one-device output of the layer before) and probe:
    every gradient leaf (the layer's params, the shared attention's at a
    hit, the input), this rank's blocks summed over the axes they are
    replicated on and gathered, within ``tol`` relative L2 of one
    device's, and none zero or non-finite.  Every rank computes both.
    Returns (worst (leaf, err), the worst leaf of each layer, leaves)."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel import sharding as shlib
    B, S = batch["tokens"].shape
    dev = batch["tokens"].device
    pos = torch.broadcast_to(torch.arange(S, device=dev), (B, S))
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    shared_lay, _ = _layouts(M.shared_attn_specs(cfg), mesh, rules)
    shared_plan = {p: v[:2] for p, v in shared_lay.items()
                   if v[0] != v[1]}
    with torch.no_grad():
        x = L.embed_tokens({"embedding": _cast(
            full["embed"]["embedding"], cfg)}, batch["tokens"], cfg)
    worst, per_layer, n_leaves, bad = ("", 0.0), [], 0, []
    for gi, g in enumerate(cfg.groups):
        lay, whole = _layouts(M.group_param_specs(cfg, g), mesh, rules,
                              strip=1)
        with shlib.sharding_ctx(mesh, rules, batch=B, seq=S):
            gl = M._gather_fsdp(local["decoder"][f"g{gi}"], whole)
        for r in range(g.repeat):
            pf = M._index_tree(full["decoder"][f"g{gi}"], r)
            pl = M._index_tree(gl, r)
            for li, ls in enumerate(g.layers):
                key = f"L{li}"
                where = f"g{gi}.r{r}.{key}"
                probe = torch.randn(x.shape, generator=gen, device=dev)
                hit = ls.shared_attn
                y1, g1 = layer_grads(torch, cfg, ls, pf[key],
                                     full["shared_attn"] if hit else None,
                                     x, probe, pos)
                plan = {p[len(key) + 1:]: v[:2] for p, v in lay.items()
                        if p.startswith(key + ".") and v[0] != v[1]}
                with shlib.sharding_ctx(mesh, rules, batch=B, seq=S):
                    res = L.residual_spec()
                    rows = (res[0], None)
                    _, g2 = layer_grads(
                        torch, cfg, ls, pl[key],
                        local["shared_attn"] if hit else None,
                        shlib.local_shard(x, res, mesh),
                        shlib.local_shard(probe, res, mesh),
                        shlib.local_shard(pos, rows, mesh), plan,
                        shared_plan)
                errs = {}
                for k, gk in g2.items():
                    if k == "x":
                        whole = C.relayout(gk, res, (None,) * 3, mesh)
                    else:
                        ps, _, rep = (shared_lay[k[len("shared_attn."):]]
                                      if k.startswith("shared_attn.")
                                      else lay[f"{key}.{k}"])
                        whole = C.relayout(C.psum(gk, rep, mesh), ps,
                                           (None,) * len(ps), mesh)
                    errs[k] = rel_l2(whole, g1[k])
                    if not bool(torch.isfinite(whole).all()) or \
                            float(whole.float().norm()) == 0:
                        bad.append(f"{where}.{k}")
                top = max(errs, key=errs.get)
                per_layer.append((where, top, errs[top]))
                n_leaves += len(errs)
                if errs[top] > worst[1]:
                    worst = (f"{where}.{top}", errs[top])
                x = y1
                del g1, g2
    over = [(w, k, e) for w, k, e in per_layer if e > tol]
    if bad or over:
        raise AssertionError(f"mesh layer gate: zero or non-finite "
                             f"gradients {bad[:5]}; layers over {tol}: "
                             f"{over}")
    return worst, per_layer, n_leaves


def _gathered_check(torch, tree, specs, mesh, rules, want, rank, kind):
    """Each leaf of this rank's blocks gathered whole (a collective) and,
    on rank 0, held against ``want[path]`` (host tensors): the worst
    relative L2 ("rel") or max abs difference ("abs"), and its leaf."""
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel import sharding as shlib
    flat = dict(shlib.tree_leaves_with_path(specs))
    worst = ("", 0.0)
    for path, blk in shlib.tree_leaves_with_path(tree):
        lay = shlib.param_sharding(mesh, flat[path], rules)
        whole = C.relayout(blk, lay, (None,) * len(lay), mesh)
        if rank != 0:
            continue
        w = want[path].to(whole.device)
        err = (rel_l2(whole, w) if kind == "rel"
               else float((whole.double() - w.double()).abs().max()))
        if err > worst[1] or not math.isfinite(err):
            worst = (path, err)
        del whole, w
    return worst


def _mesh_train_kernels(torch, device):
    """`flash_fwd` and `ssd_scan` at a (2, 2) train rank's local-head
    shapes (one row, zamba2's 16 shared-attention and 56 SSD heads of a
    model shard) against their plain versions: (name, case, err, tol)."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssd import kernel as ssk
    g = torch.Generator(device=device).manual_seed(9)

    def up(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=device) * scale).to(
            torch.bfloat16)
    q, k, v = (up(1, 2048, 16, 112) for _ in range(3))
    got, _ = fk.flash_fwd(q, k, v, causal=True)
    want, _ = fk.flash_fwd_plain(q, k, v, causal=True)
    out = [("flash_fwd", "B=1 S=2048 Hq=Hkv=16 D=112",
            float((got.float() - want.float()).abs().max()), 2e-2)]
    x = up(1, 2048, 56, 64)
    dt = torch.nn.functional.softplus(torch.randn(
        (1, 2048, 56), generator=g, device=device))
    A = -torch.exp(torch.randn((56,), generator=g, device=device) * 0.3)
    Bm, Cm = up(1, 2048, 1, 64, scale=0.5), up(1, 2048, 1, 64, scale=0.5)
    y, _ = ssk.ssd_scan(x, dt, A, Bm, Cm, chunk=256)
    wy, _ = ssk.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=256)
    out.append(("ssd_scan", "B=1 S=2048 H=56 P=64 N=64 chunk=256",
                float((y.float() - wy.float()).abs().max()),
                1e-2 * float(wy.float().abs().max())))
    return out


def mesh_train_rank(rank, world, init_file, backend, device, job, results):
    """One rank of `mesh_train_phase` (a spawned process): its readings,
    or its traceback, on ``results``."""
    import traceback
    # four ranks share one card near its capacity at d's int8 step (~17
    # GiB each): segments that grow in place keep a rank's cache from
    # fragmenting into more than it needs (a run ran out of memory there)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    try:
        results.put((rank, "ok", _mesh_train_rank(rank, world, init_file,
                                                  backend, device, job)))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))


def _free(torch, device):
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _peak(torch, device):
    return (torch.cuda.max_memory_allocated() / 2 ** 30
            if device == "cuda" else 0.0)


def _mesh_train_rank(rank, world, init_file, backend, device, job):
    import datetime
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.models.convert import shard_params
    from repro_torch.optim.adamw import adamw_update
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.sharding import (DEFAULT_RULES, _set_path,
                                               tree_leaves_with_path)
    from repro_torch.training.train_state import (_leaf_axes,
                                                  loss_and_grads,
                                                  make_train_step)
    on_card = device == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(0)
    elif job.get("require_cuda", True):
        raise RuntimeError("a mesh-train rank found no CUDA device")
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=900))
    rules = DEFAULT_RULES
    out = {"rank": rank}
    try:
        mesh = make_host_mesh(*job["mesh"])
        B, S, seed = job["B"], job["S"], job["seed"]
        if on_card and job.get("kernels"):
            out["kernels"] = _mesh_train_kernels(torch, device)

        def zero_state(params):
            return {"m": _zeros_like(torch, params),
                    "v": _zeros_like(torch, params)}
        step0 = torch.zeros((), dtype=torch.int32, device=device)

        # ---- a. the 7-layer f32 zamba2: one step against one device --- #
        cfg = job["f32"]
        specs = M.model_param_specs(cfg)
        full = train_params(torch, cfg, seed, device)
        params = shard_params(full, specs, mesh, rules, device=device)
        del full
        _free(torch, device)
        batch = train_batch(torch, cfg, B, S, seed, device)
        # the same step's gradients under remat "dots", held against the
        # "full" ones below (before the update moves the params)
        reset_model_launches()
        t0 = time.perf_counter()
        met_d, grads_d = loss_and_grads(cfg.replace(remat="dots"), params,
                                        batch, mesh, rules)
        sync(torch, device)
        dots = {"loss": float(met_d["loss"]), "s": time.perf_counter() - t0,
                "launches": model_launches()}
        C.reset_stats()
        reset_model_launches()
        sync(torch, device)
        t0 = time.perf_counter()
        met, grads = loss_and_grads(cfg, params, batch, mesh, rules)
        adamw_update(_mesh_opt(), params, grads, zero_state(params), step0,
                     mesh=mesh, leaf_axes=_leaf_axes(cfg, mesh, rules))
        sync(torch, device)
        a = {"loss": float(met["loss"]), "s": time.perf_counter() - t0,
             "wire": dict(C.STATS), "peak_gib": _peak(torch, device),
             "launches": model_launches()}
        got = dict(tree_leaves_with_path(grads_d))
        per = {p: float((got[p].double() - g.double()).norm()
                        / g.double().norm().clamp_min(1e-30))
               for p, g in tree_leaves_with_path(grads)}
        worst = max(per, key=per.get)
        a["dots"] = dict(dots, worst=(worst, per[worst]), leaves=len(per),
                         equal=sum(bool(torch.equal(got[p], g)) for p, g in
                                   tree_leaves_with_path(grads)))
        del grads_d, got
        want = (torch.load(Path(job["root"]) / "single_f32.pt", mmap=True)
                if rank == 0 else None)
        a["worst_grad"] = _gathered_check(
            torch, grads, specs, mesh, rules, want and want["grads"], rank,
            "rel")
        a["param_err"] = _gathered_check(
            torch, params, specs, mesh, rules, want and want["params"], rank,
            "abs")
        if rank == 0:
            a["loss_single"] = want["loss"]
        out["f32"] = a
        del params, grads, want, batch
        _free(torch, device)

        # ---- b. the 13-layer bf16 zamba2: layer gate, timed steps ----- #
        cfg = job["bf16"]
        specs = M.model_param_specs(cfg)
        full = train_params(torch, cfg, seed, device)
        params = shard_params(full, specs, mesh, rules, device=device)
        half = {}
        for path, t in tree_leaves_with_path(full):
            _set_path(half, path, _cast(t, cfg))
        del full
        _free(torch, device)
        batch = train_batch(torch, cfg, B, S, seed, device)
        t0 = time.perf_counter()
        worst, per_layer, n_leaves = mesh_layer_gate(torch, cfg, half,
                                                     params, batch, mesh,
                                                     rules)
        b = {"gate_worst": worst, "gate_layers": per_layer,
             "gate_leaves": n_leaves, "gate_s": time.perf_counter() - t0}
        del half
        _free(torch, device)
        state = {"params": params, "opt": zero_state(params), "step": step0}
        step = make_train_step(cfg, _mesh_opt(), mesh, rules)
        state, met = step(state, batch)               # warm-up
        sync(torch, device)
        _free(torch, device)
        C.reset_stats()
        reset_model_launches()
        times, losses = [], [float(met["loss"])]
        for _ in range(job["n_steps"]):
            sync(torch, device)
            t0 = time.perf_counter()
            state, met = step(state, batch)
            sync(torch, device)
            times.append(time.perf_counter() - t0)
            losses.append(float(met["loss"]))
        b.update(step_s=times, losses=losses, wire=dict(C.STATS),
                 launches=model_launches(), peak_gib=_peak(torch, device))
        out["bf16"] = b
        del state, params, batch
        _free(torch, device)

        # ---- d. the 2-layer f32 qwen3-moe: exact and int8 all-to-all -- #
        cfg = job["moe"]
        specs = M.model_param_specs(cfg)
        full = train_params(torch, cfg, seed, device)
        init = shard_params(full, specs, mesh, rules, device=device)
        del full
        _free(torch, device)
        batch = train_batch(torch, cfg, B, S, seed, device)
        axes = _leaf_axes(cfg, mesh, rules)
        d, exact = {}, {}
        for int8 in (False, True):
            c = cfg.replace(moe_a2a_int8=int8)
            params = {}
            for path, t in tree_leaves_with_path(init):
                _set_path(params, path, t.clone())
            C.reset_stats()
            sync(torch, device)
            t0 = time.perf_counter()
            met, grads = loss_and_grads(c, params, batch, mesh, rules)
            _, _, stats = adamw_update(_mesh_opt(), params, grads,
                                       zero_state(params), step0, mesh=mesh,
                                       leaf_axes=axes)
            sync(torch, device)
            rec = d["int8" if int8 else "exact"] = {
                "loss": float(met["loss"]), "s": time.perf_counter() - t0,
                "grad_norm": float(stats["grad_norm"]),
                "finite": all(bool(torch.isfinite(g).all()) for _, g in
                              tree_leaves_with_path(grads)),
                "wire": dict(C.STATS), "peak_gib": _peak(torch, device)}
            if not int8:
                # kept on the host: a second gradient tree on each of the
                # four ranks would not fit beside the int8 step's peak
                exact = {p: g.cpu() for p, g in tree_leaves_with_path(grads)}
            else:
                # each leaf's relative L2 against the exact gradient, over
                # the whole leaf (its blocks' sums psummed over its axes)
                rec["grad_rel"], rec["grad_rels"] = ("", 0.0), {}
                for path, g in tree_leaves_with_path(grads):
                    e = exact[path].to(g.device)
                    num = C.psum(torch.sum(torch.square(g - e)), axes[path],
                                 mesh)
                    den = C.psum(torch.sum(torch.square(e)), axes[path],
                                 mesh)
                    rel = float(torch.sqrt(num / torch.clamp(den,
                                                             min=1e-30)))
                    rec["grad_rels"][path] = rel
                    if rel >= rec["grad_rel"][1]:
                        rec["grad_rel"] = (path, rel)
            del params, grads
            _free(torch, device)
        del exact
        out["moe"] = d
        return out
    finally:
        dist.destroy_process_group()


def moe_train_phase(torch, cfg, device="cuda", B=2, S=2048, seed=31,
                    n_steps=2):
    """Phase c: qwen3-moe-30b-a3b at full width, cut in depth, bf16 with
    f32 masters, on one device: each layer's gradients through the
    kernels against the plain torch paths (the kernel route's MoE on the
    plain route's experts, as `layer_routes` pins them) within 5e-2
    relative L2, then one warm-up and ``n_steps`` timed AdamW steps with
    each layer's expert counts and drops and a profile of one step."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_lib
    from repro_torch.training.train_state import make_train_step
    t0 = time.perf_counter()
    params = train_params(torch, cfg, seed, device)
    batch = train_batch(torch, cfg, B, S, seed, device)
    n_layers = sum(g.repeat for g in cfg.groups)
    log(f"[moe-train] {cfg.name}: {n_layers} layers at full width, "
        f"{M.count_params(cfg)} params (f32 masters) drawn in "
        f"{time.perf_counter() - t0:.1f}s; B={B} S={S}")
    # ---- the layer gate ------------------------------------------------- #
    t0 = time.perf_counter()
    (g,) = cfg.groups
    (ls,) = g.layers
    pos = torch.broadcast_to(torch.arange(S, device=device), (B, S))
    gen = torch.Generator(device=device)
    gen.manual_seed(29)
    route = moe_lib._route
    with torch.no_grad():
        x = L.embed_tokens({"embedding": _cast(
            params["embed"]["embedding"], cfg)}, batch["tokens"], cfg)
    worst, per_layer, bad = ("", 0.0), [], []
    for r in range(g.repeat):
        p = M._index_tree(params["decoder"]["g0"], r)["L0"]
        probe = torch.randn(x.shape, generator=gen, device=device)
        chose = []

        def plain_route(xf, w, k):
            out = route(xf, w, k)
            chose.append(out[1])
            return out

        def pinned(xf, w, k):
            _, _, probs = route(xf, w, k)
            gg = probs.gather(1, chose[0])
            return (gg / gg.sum(-1, keepdim=True).clamp_min(1e-9), chose[0],
                    probs)
        try:
            moe_lib._route = plain_route
            y, gp = layer_grads(torch, cfg.replace(use_pallas=False), ls, p,
                                None, x, probe, pos)
            moe_lib._route = pinned
            _, gk = layer_grads(torch, cfg, ls, p, None, x, probe, pos)
        finally:
            moe_lib._route = route
        errs = {k: rel_l2(gk[k], gp[k]) for k in gp}
        bad += [f"L{r}.{k}" for k in gp if float(gk[k].norm()) == 0
                or not bool(torch.isfinite(gk[k]).all())]
        top = max(errs, key=errs.get)
        per_layer.append((f"L{r}", top, errs[top]))
        if errs[top] > worst[1]:
            worst = (f"L{r}.{top}", errs[top])
        x = y
        del gk, gp
    log(f"[moe-train] bf16 layer by layer, kernels vs plain on the same "
        f"input and probe (the MoE on the plain route's experts): worst "
        f"{worst[0]} rel L2 {worst[1]:.3e} (limit 5e-2); worst leaf per "
        f"layer {json.dumps([(w, k, round(e, 5)) for w, k, e in per_layer])}"
        f"; zero or non-finite {bad} in {time.perf_counter() - t0:.1f}s")
    if bad or worst[1] > 5e-2:
        fail(f"qwen3-moe bf16 layer gate: worst {worst}, bad {bad}")
    # ---- timed steps ------------------------------------------------------ #
    state = {"params": params,
             "opt": {k: _zeros_like(torch, params) for k in ("m", "v")},
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    step = make_train_step(cfg, _mesh_opt())
    state, met = step(state, batch)                 # warm-up
    sync(torch, device)
    base = 0
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    reset_model_launches()
    calls = []

    def recording(xf, w, k):
        out = route(xf, w, k)
        calls.append(out[1])
        return out
    times, losses = [], [float(met["loss"])]
    moe_lib._route = recording
    try:
        for i in range(n_steps):
            sync(torch, device)
            t0 = time.perf_counter()
            state, met = step(state, batch)
            sync(torch, device)
            times.append(time.perf_counter() - t0)
            losses.append(float(met["loss"]))
            if i == 0:
                # the forward's calls (remat recomputes each layer's)
                fwd = calls[:n_layers]
    finally:
        moe_lib._route = route
    record_step(torch, "moe-train", cfg, statistics.median(times),
                (state, batch), base, device)
    launches = model_launches()
    peak = _peak(torch, device)
    N = B * S
    cap = moe_lib.capacity(cfg, N)
    routing = []
    for e in fwd:
        counts = torch.bincount(e.reshape(-1), minlength=cfg.num_experts)
        routing.append({"min": int(counts.min()), "max": int(counts.max()),
                        "dropped": int((counts - cap).clamp_min(0).sum())})
    med = statistics.median(times)
    if not all(math.isfinite(v) for v in losses):
        fail(f"qwen3-moe train losses not finite: {losses}")
    want = route_counts(2 * n_layers * n_steps, 0, 2 * n_layers * n_steps,
                        0) if device == "cuda" else route_counts(0, 0, 0, 0)
    if launches != want:
        fail(f"{n_steps} qwen3-moe train steps launched {launches}, "
             f"expected {want}")
    log(f"[moe-train] bf16 AdamW step: median {med:.4f}s over {n_steps} "
        f"steps (each {json.dumps([round(v, 4) for v in times])}) = "
        f"{N / med:.0f} tokens/s; peak memory {peak:.2f} GiB; losses "
        f"{json.dumps([round(v, 5) for v in losses])}; per layer (forward) "
        f"expert counts min/max and dropped assignments of {N * cfg.experts_per_token} "
        f"(capacity {cap}) {json.dumps(routing)}; launches "
        f"{json.dumps(launches)} ({card_or_cpu(device)})")
    classes = {}
    if device == "cuda":
        with slice_ranges():
            classes = profile_ranges(torch, "one bf16 qwen3-moe train step",
                                     lambda: step(state, batch), med * 1e3,
                                     TRAIN_RANGES + MOE_RANGES)
    del state, params, batch
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"step_s": med, "tokens_per_s": N / med, "peak_gib": peak,
            "launches": launches, "routing": routing, "classes": classes,
            "gate": worst, "layers": n_layers}


def mesh_train_phase(torch, job=None, device="cuda", limit=900.0):
    """Training over a (data, model) mesh under `DEFAULT_RULES` (FSDP over
    ``data``, TP and the sequence-split residual over ``model``): the
    one-device steps of ``job`` (`mesh_train_jobs`) in this process (a's
    f32 reference step, c's qwen3-moe), the card freed, then 4 spawned
    gloo ranks sharing it as a (2, 2) mesh run a, b and d (every rank
    first holds `flash_fwd` and `ssd_scan` at its local shapes against
    their plain versions).  Fails unless a's mesh step is within 1e-4
    (loss), 1e-3 relative L2 (each gradient leaf) and 5e-4 (params) of
    one device's and its gradients under remat "dots" equal its own
    under "full" (or lie within 1e-5 relative, with the same launches),
    b's layer gate holds and its steps launch both kernels on every
    rank, and d's int8 loss lies within 5e-2 of the exact one, its worst
    gradient leaf within `INT8_GRAD_REL` relative L2 of the exact one's,
    and every gradient is finite.  Returns rank 0's
    launches over b's timed steps, and c's."""
    root = ROOT / "build" / "chip_mesh_train"
    job = dict(job or mesh_train_jobs(), root=str(root))
    if device != "cuda":
        job["require_cuda"] = False
    t0 = time.perf_counter()
    single = f32_single_step(torch, job, root, device)
    log(f"[mesh-train] a: one-device f32 step of the 7-layer zamba2 (B="
        f"{job['B']} S={job['S']}): loss {single['loss']:.6f} in "
        f"{single['s']:.2f}s, peak {single['peak_gib']:.2f} GiB "
        f"({card_or_cpu(device)})")
    reset_model_launches()
    moe = moe_train_phase(torch, job["moe_single"], device, job["B"],
                          job["S"], job["seed"])
    if device == "cuda":
        torch.cuda.empty_cache()
    log(f"[mesh-train] this process holds "
        f"{torch.cuda.memory_allocated() if device == 'cuda' else 0} bytes "
        f"of the card before spawning the ranks")
    outs = spawn_mesh_ranks(4, root, "gloo", device, job, limit,
                            target=mesh_train_rank)
    wall = time.perf_counter() - t0
    (root / "single_f32.pt").unlink(missing_ok=True)
    n_tok = job["B"] * job["S"]
    for o in outs:
        r = o["rank"]
        for name, case, err, tol in o.get("kernels", []):
            log(f"[mesh-train] rank {r} {name} {case} bf16 against its "
                f"plain version: max abs err {err:.3e} (tolerance "
                f"{tol:.3g})")
            if not err <= tol:
                fail(f"mesh-train rank {r}: {name} {case} off by {err:.3e}")
        a, b = o["f32"], o["bf16"]
        for what, run in (("a f32 step", a), ("d exact", o["moe"]["exact"]),
                          ("d int8", o["moe"]["int8"])):
            w = run["wire"]
            log(f"[mesh-train] rank {r} {what}: {run['s']:.2f}s, loss "
                f"{run['loss']:.6f}; wire {w.get('wire_bytes', 0)} bytes in "
                f"{sum(v for k, v in w.items() if k in COLLECTIVES)} calls, "
                f"host hop {w.get('hop_bytes', 0)} bytes, "
                f"{w.get('seconds', 0):.2f}s in collectives; peak "
                f"{run['peak_gib']:.2f} GiB ({card_or_cpu(device)})")
        w, med = b["wire"], statistics.median(b["step_s"])
        n = job["n_steps"]
        log(f"[mesh-train] rank {r} b bf16 13-layer step: median {med:.3f}s "
            f"(each {json.dumps([round(v, 3) for v in b['step_s']])}) = "
            f"{n_tok / med:.0f} tokens/s of the mesh; per step: wire "
            f"{w.get('wire_bytes', 0) // n} bytes, "
            f"{sum(v for k, v in w.items() if k in COLLECTIVES) // n} calls "
            f"({json.dumps({k: v // n for k, v in w.items() if k in COLLECTIVES})}), "
            f"host hop {w.get('hop_bytes', 0) // n} bytes, "
            f"{w.get('seconds', 0) / n:.3f}s in collectives; peak "
            f"{b['peak_gib']:.2f} GiB; launches a step "
            f"{json.dumps({k: v // n for k, v in b['launches'].items()})}; "
            f"losses {json.dumps([round(v, 5) for v in b['losses']])} "
            f"({card_or_cpu(device)})")
        n_ssd, n_attn = layer_counts(job["bf16"])
        want = (route_counts(2 * n_attn * n, 2 * n_ssd * n, 2 * n_attn * n,
                             2 * n_ssd * n) if device == "cuda"
                else route_counts(0, 0, 0, 0))
        if b["launches"] != want:
            fail(f"mesh-train rank {r}: {n} bf16 steps launched "
                 f"{b['launches']}, expected {want}")
        if not all(math.isfinite(v) for v in b["losses"]):
            fail(f"mesh-train rank {r}: bf16 losses {b['losses']}")
    o0 = outs[0]
    a = o0["f32"]
    loss_err = abs(a["loss"] - a["loss_single"])
    log(f"[mesh-train] a: the (2, 2) f32 step against one device's: loss "
        f"{a['loss']:.6f} vs {a['loss_single']:.6f} (diff {loss_err:.3e}, "
        f"limit 1e-4); worst gradient leaf {a['worst_grad'][0]} rel L2 "
        f"{a['worst_grad'][1]:.3e} (limit 1e-3); params after the step max "
        f"abs {a['param_err'][1]:.3e} at {a['param_err'][0]} (limit 5e-4)")
    if not (loss_err <= 1e-4 and a["worst_grad"][1] <= 1e-3
            and a["param_err"][1] <= 5e-4):
        fail("mesh-train a: the mesh f32 step differs from one device's")
    if any(abs(o["f32"]["loss"] - a["loss"]) > 0 for o in outs):
        fail("mesh-train a: the ranks' losses differ")
    for o in outs:
        f, d = o["f32"], o["f32"]["dots"]
        lrel = abs(d["loss"] - f["loss"]) / abs(f["loss"])
        log(f"[mesh-train] a rank {o['rank']}: the (2, 2) f32 step under "
            f"remat dots against full: loss {d['loss']:.6f} vs "
            f"{f['loss']:.6f} ({'equal' if lrel == 0 else f'rel {lrel:.3e}'})"
            f"; {d['equal']} of {d['leaves']} gradient blocks bit-equal, "
            f"worst {d['worst'][0]} rel L2 {d['worst'][1]:.3e} (limit 1e-5); "
            f"{d['s']:.2f}s; launches {json.dumps(d['launches'])} (full "
            f"{json.dumps(f['launches'])})")
        if not (lrel <= 1e-5 and d["worst"][1] <= 1e-5
                and d["launches"] == f["launches"]):
            fail(f"mesh-train a rank {o['rank']}: remat dots differs from "
                 "full")
    b = o0["bf16"]
    log(f"[mesh-train] b: bf16 layer gate, each layer on the mesh vs one "
        f"device on the same input and probe: {b['gate_leaves']} gradient "
        f"leaves, worst {b['gate_worst'][0]} rel L2 {b['gate_worst'][1]:.3e} "
        f"(limit 5e-2) in {b['gate_s']:.1f}s; worst leaf per layer "
        f"{json.dumps([(w, k, round(e, 5)) for w, k, e in b['gate_layers']])}")
    d = o0["moe"]
    top = sorted(d["int8"]["grad_rels"].items(), key=lambda kv: -kv[1])[:4]
    lrel = abs(d["int8"]["loss"] - d["exact"]["loss"]) / abs(
        d["exact"]["loss"])
    log(f"[mesh-train] d: 2-layer f32 qwen3-moe on (2, 2): int8 all-to-all "
        f"loss {d['int8']['loss']:.6f} vs exact {d['exact']['loss']:.6f} "
        f"(rel {lrel:.3e}, limit 5e-2); gradient leaves against exact, rel L2, worst first "
        f"{json.dumps([(k, float(f'{v:.4g}')) for k, v in top])} (limit "
        f"{INT8_GRAD_REL:g}); grad norms {d['exact']['grad_norm']:.4f} / "
        f"{d['int8']['grad_norm']:.4f}")
    for o in outs:
        d = o["moe"]
        rel = abs(d["int8"]["loss"] - d["exact"]["loss"]) / abs(
            d["exact"]["loss"])
        path, grel = d["int8"]["grad_rel"]
        if not (rel < 5e-2 and grel <= INT8_GRAD_REL and d["exact"]["finite"]
                and d["int8"]["finite"]):
            fail(f"mesh-train d rank {o['rank']}: int8 loss rel {rel:.3e}, "
                 f"worst gradient leaf {path} rel L2 {grel:.3e}, finite "
                 f"{d['exact']['finite']} / {d['int8']['finite']}")
    log("[mesh-train] d: every gradient finite on every rank")
    log(f"[mesh-train] wall {wall:.1f}s ({card_or_cpu(device)})")
    return {"mesh": b["launches"], "per_step": {
        k: v // job["n_steps"] for k, v in b["launches"].items()},
        "moe": moe, "bf16_wire": [o["bf16"]["wire"] for o in outs],
        "n_steps": job["n_steps"]}

# ========== the launch toolchain: the timed steps on meta tensors ======== #
# what each timed full-width step measured, by `roofline_plan` key: its
# config, seconds, argument bytes and peak (`record_step`)
ROOF_RUNS = {}
TRACE_FILE = ROOT / "build" / "chip_roofline.json"


def record_step(torch, key, cfg, seconds, args, base, device):
    """What a timed step measured, for `roofline_phase`: its seconds, the
    nbytes of its arguments (``args``, the tensors it was called on), and
    its peak: the card's high-water mark over the step less what the card
    held before it (``base``), plus the arguments."""
    from torch.utils._pytree import tree_flatten
    arg_bytes = sum(t.numel() * t.element_size()
                    for t in tree_flatten(args)[0]
                    if isinstance(t, torch.Tensor))
    peak = (torch.cuda.max_memory_allocated() - base + arg_bytes
            if device == "cuda" else 0)
    ROOF_RUNS[key] = {"cfg": repr(cfg), "s": seconds,
                      "arg_bytes": arg_bytes, "peak_bytes": peak}


def roofline_plan():
    """The full-width steps this script times, as the roofline phase
    traces them: key -> (label, config, kind, B, S, the caches' length,
    the train step's AdamW config).  Each config is built as the phase
    that times it builds it, and `roofline_phase` holds the two equal."""
    from repro_torch.configs.base import get_config
    z, q = get_config("zamba2-7b"), get_config("qwen3-moe-30b-a3b")
    bf16 = dict(dtype="bfloat16", use_pallas=True)
    return {
        "full": ("zamba2-7b bf16 prefill B=4 S=2048", z.replace(**bf16),
                 "prefill", 4, 2048, 2048 + 32, None),
        "train": ("zamba2-7b 13-layer bf16 train step B=2 S=2048",
                  z.replace(groups=train_groups(), remat="full", **bf16),
                  "train", 2, 2048, None, None),
        "moe-train": ("qwen3-moe-30b-a3b 4-layer bf16 train step B=2 "
                      "S=2048", mesh_train_jobs()["moe_single"], "train", 2,
                      2048, None, _mesh_opt()),
        "moe": ("qwen3-moe-30b-a3b 48-layer bf16 prefill B=4 S=2048",
                q.replace(**bf16), "prefill", 4, 2048, 2048 + 32, None)}


def trace_steps(out_path, plan=None, mesh_job=None):
    """The `--trace-steps` child: each step of ``plan`` (`roofline_plan`)
    traced on meta tensors on one device, then the (2, 2) mesh train step
    of ``mesh_job``'s 13-layer bf16 zamba2 (`mesh_train_jobs`: its
    ``"bf16"`` config, B and S) under a fake group of 4, on the gloo and
    the NCCL routes; written to ``out_path`` as JSON.  Host work only: it
    runs beside the card's phases."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.roofline import model_flops_of, roofline_terms
    plan = plan or roofline_plan()
    res = {"steps": {}, "mesh": {}}
    for key, (label, cfg, kind, b, s, cache_len, opt) in plan.items():
        t0 = time.perf_counter()
        tr = dryrun.trace_cell(cfg, ShapeConfig(key, s, b, kind), None,
                               cache_len=cache_len, opt=opt)
        a = tr["analysis"]
        res["steps"][key] = {
            "label": label, "cfg": repr(cfg),
            "model_flops": model_flops_of(cfg, b, s, kind),
            "analysis": {k: a[k] for k in ("flops", "dot_flops",
                                           "bytes_accessed", "n_ops")},
            "terms": roofline_terms(a), "memory": tr["memory"],
            "trace_s": time.perf_counter() - t0}
        print(f"[trace] {label}: {time.perf_counter() - t0:.1f}s",
              flush=True)
    job = mesh_job or mesh_train_jobs()
    cfg = job["bf16"]
    mesh = dryrun.make_mesh(shape=job["mesh"])
    for route in ("gloo", "nccl"):
        t0 = time.perf_counter()
        tr = dryrun.trace_cell(cfg, ShapeConfig("mesh", job["S"], job["B"],
                                                "train"), mesh, route,
                               opt=_mesh_opt())
        res["mesh"][route] = {
            "cfg": repr(cfg), "stats": tr["analysis"]["stats"],
            "terms": roofline_terms(tr["analysis"]),
            "memory": tr["memory"], "trace_s": time.perf_counter() - t0}
        print(f"[trace] mesh {route}: {time.perf_counter() - t0:.1f}s",
              flush=True)
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    Path(out_path).write_text(json.dumps(res))


def start_trace_steps():
    """`trace_steps` in a child process (`--trace-steps`), beside the card's
    phases; `finish_trace_steps` joins it."""
    import atexit
    out = ROOT / "build" / "chip_trace_steps.log"
    out.parent.mkdir(parents=True, exist_ok=True)
    TRACE_FILE.unlink(missing_ok=True)
    with open(out, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--trace-steps",
             str(TRACE_FILE)], stdout=f, stderr=subprocess.STDOUT)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, out, time.perf_counter()


def finish_trace_steps(started, limit=600.0):
    proc, out, _ = started
    t_wait = time.perf_counter()
    try:
        proc.wait(timeout=limit)
    except subprocess.TimeoutExpired:
        proc.kill()
        fail(f"the meta traces outlasted {limit} s")
    for line in out.read_text().splitlines():
        log(line)
    if proc.returncode != 0:
        fail(f"the meta traces failed ({proc.returncode})")
    traced = json.loads(TRACE_FILE.read_text())
    spent = sum(t["trace_s"] for part in ("steps", "mesh")
                for t in traced[part].values())
    log(f"[time] meta traces {spent:.1f}s of tracing beside the card's "
        f"phases; waited {time.perf_counter() - t_wait:.1f}s for them")
    return traced


def roofline_phase(traced, mesh_wire, n_steps, where=None, peak=989e12):
    """For each step of `roofline_plan`: the model FLOP, the counted FLOP
    and bytes of its meta trace, the three roofline terms on the H100
    (`launch.roofline`), the step time the phase measured and the MFU
    (model FLOP / (s x 989e12)); fails unless the trace's argument bytes
    equal the nbytes of the tensors the step ran on.  Then the meta trace
    of the (2, 2) mesh train step, gloo route, against what every rank
    of `mesh_train_phase` measured in `collectives.STATS` a step (calls
    by kind and wire bytes): fails unless equal.  ``where`` names what
    ran the timed steps (the card's name and power limit)."""
    where = where or card()
    for key, tr in traced["steps"].items():
        run = ROOF_RUNS.get(key)
        if run is None:
            fail(f"the roofline step {key} was not timed")
        if run["cfg"] != tr["cfg"]:
            fail(f"the roofline step {key} traced another config than the "
                 f"one timed:\n{tr['cfg']}\n{run['cfg']}")
        a, t, m = tr["analysis"], tr["terms"], tr["memory"]
        mfu = tr["model_flops"] / (run["s"] * peak)
        ratio = m["peak_bytes"] / run["peak_bytes"] if run["peak_bytes"] \
            else float("nan")
        log(f"[roofline] {tr['label']}: model FLOP {tr['model_flops']:.4e}; "
            f"counted {a['flops']:.4e} FLOP ({a['dot_flops']:.4e} in "
            f"products), {a['bytes_accessed']:.4e} bytes unfused, "
            f"{a['n_ops']} ops; compute {t['compute_s']:.5f}s, memory "
            f"{t['memory_s']:.5f}s, collective {t['collective_s']:.5f}s: "
            f"{t['dominant']}-bound; measured {run['s']:.4f}s, MFU "
            f"{mfu:.4f}; arguments {m['argument_bytes']} bytes traced, "
            f"{run['arg_bytes']} on the card; peak {m['peak_bytes']} bytes "
            f"traced, {run['peak_bytes']} measured (ratio {ratio:.3f}); "
            f"traced in {tr['trace_s']:.1f}s ({where})")
        if m["argument_bytes"] != run["arg_bytes"]:
            fail(f"{key}: the trace's arguments ({m['argument_bytes']} bytes)"
                 f" are not the step's ({run['arg_bytes']} bytes)")
    keys = COLLECTIVES + ("wire_bytes",)
    gloo, nccl = traced["mesh"]["gloo"], traced["mesh"]["nccl"]
    want = {k: v for k, v in gloo["stats"].items() if k in keys}
    for r, wire in enumerate(mesh_wire):
        got = {k: v // n_steps for k, v in wire.items() if k in keys and v}
        if any(wire[k] % n_steps for k in got) or got != want:
            fail(f"mesh train rank {r} measured {json.dumps(wire)} over "
                 f"{n_steps} steps; the gloo route's trace counts "
                 f"{json.dumps(want)} a step")
    log(f"[roofline] mesh cross-check, the (2, 2) 13-layer bf16 zamba2 "
        f"train step a rank a step: the fake-group trace, gloo route, "
        f"{json.dumps(want)} equals what each of the {len(mesh_wire)} ranks "
        f"measured; the NCCL route would issue "
        f"{json.dumps({k: v for k, v in nccl['stats'].items() if k in keys})}"
        f" (collective term {nccl['terms']['collective_s']:.4f}s over NVLink "
        f"and the network, gloo route {gloo['terms']['collective_s']:.4f}s); "
        f"traced arguments {gloo['memory']['argument_bytes']} bytes, peak "
        f"{gloo['memory']['peak_bytes']} bytes a rank")


def card_or_cpu(device):
    return card() if device == "cuda" else "cpu"


def ptxas_summary(build_log, tag):
    """What `ptxas -v` reported for each kernel whose mangled name holds
    ``tag``: registers, spill bytes, and its warnings that wgmma products
    were serialised (C7515), by the name's template arguments."""
    out, cur = {}, None

    def rec(name):
        return out.setdefault(name.split(tag)[-1].split("EEEv")[0], {
            "registers": None, "spill_stores": None, "spill_loads": None,
            "serialized": 0})

    for line in build_log.splitlines():
        named = re.search(r"function '(\w+)'", line)
        if "C7515" in line:
            if named and tag in named.group(1):
                rec(named.group(1))["serialized"] += 1
            continue
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            cur = m.group(1) if tag in m.group(1) else None
        if cur is None:
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rec(cur)["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            rec(cur)["spill_stores"], rec(cur)["spill_loads"] = \
                map(int, m.groups())
    return out


def main():
    global LOG_FILE
    t_main = time.perf_counter()
    if os.environ.get("PYTHONHASHSEED") != "0":
        env = dict(os.environ, PYTHONHASHSEED="0")
        os.execve(sys.executable,
                  [sys.executable, str(Path(__file__).resolve()),
                   *sys.argv[1:]], env)
    if not (SRC / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}")
    sys.path.insert(0, str(SRC))
    if sys.argv[1:] == ["--paper-tables"]:
        from repro_torch import scenarios
        paper_tables_phase(scenarios)
        return
    if sys.argv[1:2] == ["--trace-steps"] and len(sys.argv) == 3:
        trace_steps(sys.argv[2])
        return
    import torch
    if not torch.cuda.is_available():
        fail("torch finds no CUDA device")
    LOG_FILE = ROOT / "build" / "chip_smoke.log"
    LOG_FILE.parent.mkdir(exist_ok=True)
    LOG_FILE.write_text("")
    from repro_torch import kernels_build, scenarios
    from repro_torch.core import swarm_kernels as sk
    kind = torch.cuda.get_device_name(0)
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {kind} "
        f"count {torch.cuda.device_count()}")

    mesh_only = sys.argv[1:] == ["--mesh-serve"]
    train_only = sys.argv[1:] == ["--mesh-train"]
    tables = None if mesh_only or train_only else start_paper_tables()
    t0 = time.perf_counter()
    kernels_build.load()
    info = kernels_build.BUILD_INFO
    log(f"[build] {info['path']} in {time.perf_counter() - t0:.2f}s "
        f"(nvcc {info['seconds']:.2f}s)")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[build] {line.strip()}")
    log("[build] flash_fwd_wgmma_kernel<T, boxes, k-steps> (ptxas -v): "
        + json.dumps(ptxas_summary(info["log"], "flash_fwd_wgmma_kernel")))
    log("[build] ssd_scan_wgmma_kernel<P boxes, N boxes> (ptxas -v): "
        + json.dumps(ptxas_summary(info["log"], "ssd_scan_wgmma_kernel")))

    if mesh_only:
        t0 = time.perf_counter()
        mesh_serve_phase(torch)
        log(f"[time] mesh-serve phase {time.perf_counter() - t0:.1f}s")
        return
    if train_only:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        mesh_train_phase(torch)
        log(f"[time] mesh-train phase {time.perf_counter() - t0:.1f}s")
        return
    records = kernel_phase(torch, sk)
    finish_paper_tables(tables)
    traces = start_trace_steps()

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
    # bf16: flash and the scan on wgmma (`route_counts`)
    missing = [k for k in ("flash_fwd", "flash_fwd.wgmma", "ssd_scan",
                           "ssd_scan.wgmma") if serve_launches[k] <= 0]
    if missing:
        fail(f"kernels never launched on the serve path: {missing}")
    launches.update(serve_launches)

    # ---- train slice ----------------------------------------------------- #
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train = train_step_phase(torch)
    log(f"[time] train-step phase {time.perf_counter() - t0:.1f}s")
    missing = [k for k in ("flash_fwd", "ssd_scan") if train["launches"][k]
               <= 0 or train["dots"]["per_step"][k] <= 0]
    if missing:
        fail(f"kernels never launched on the train path: {missing}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    trainer_phase(torch)
    log(f"[time] trainer phase {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()
    examples_phase()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    swarm_restore_phase(torch)
    log(f"[time] swarm-restore phase {time.perf_counter() - t0:.1f}s")

    # ---- MoE and encoder-decoder slice ------------------------------------ #
    torch.cuda.empty_cache()
    slice_launches = moe_encdec_phases(torch)
    reference_tree.cache_clear()        # the last reference file's weights
    for name, counts in slice_launches.items():
        if counts["flash_fwd.wgmma"] <= 0:
            fail(f"flash_fwd never launched on the {name} path")

    # ---- the torrent ring across ranks (the tables ran beside the build) -- #
    torch.cuda.empty_cache()
    log(f"[torrent] this process holds {torch.cuda.memory_allocated()} "
        f"bytes of the card before spawning the ranks")
    t0 = time.perf_counter()
    torrent_restore_phase(torch)
    log(f"[time] torrent-restore phase {time.perf_counter() - t0:.1f}s")

    # ---- serving over a (data, model) mesh -------------------------------- #
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh_launches = mesh_serve_phase(torch)
    log(f"[time] mesh-serve phase {time.perf_counter() - t0:.1f}s")
    for name in ("zamba2", "moe", "encdec"):
        if mesh_launches[name]["flash_fwd.wgmma"] <= 0:
            fail(f"flash_fwd never launched on the mesh's {name} path")
    if mesh_launches["zamba2"]["ssd_scan.wgmma"] <= 0:
        fail("ssd_scan never launched on the mesh's zamba2 path")

    # ---- training over a (data, model) mesh ------------------------------ #
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh_train = mesh_train_phase(torch)
    log(f"[time] mesh-train phase {time.perf_counter() - t0:.1f}s")
    for k in ("flash_fwd.wgmma", "ssd_scan.wgmma"):
        if mesh_train["mesh"][k] <= 0:
            fail(f"{k} never launched on the mesh train path")
    if mesh_train["moe"]["launches"]["flash_fwd.wgmma"] <= 0:
        fail("flash_fwd never launched on the qwen3-moe train path")

    # ---- the launch toolchain: the timed steps on meta tensors ----------- #
    t0 = time.perf_counter()
    roofline_phase(finish_trace_steps(traces), mesh_train["bf16_wire"],
                   mesh_train["n_steps"])
    log(f"[time] roofline phase {time.perf_counter() - t0:.1f}s")

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
            # flash: the mma.sync kernel that the wgmma one replaced, in
            # turns with it
            "v2_ms": rec.get("v2_ms"),
            # every timed shape of the kernel (flash: the six main-path
            # shapes, each in turns with v2 and beside SDPA)
            "shapes": [{k: r.get(k) for k in (
                "case", "ms", "v1_ms", "v2_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms")}
                for r in records[name] if "ms" in r],
            "route_launches": {k: v for k, v in launches.items()
                               if k.startswith(name + ".")
                               or (k == name and k != kernel)},
            # the train path: the timed bf16 steps (forward + recompute)
            "train_launches": train["launches"].get(kernel, 0),
            "train_launches_per_step": train["per_step"].get(kernel, 0),
            # the same steps under remat "dots" (the kernels recomputed)
            "train_dots_launches_per_step": train["dots"]["per_step"].get(
                kernel, 0),
            # the bf16 prefill + decode of qwen3-moe and of seamless
            "moe_launches": slice_launches["moe"].get(kernel, 0),
            "encdec_launches": slice_launches["encdec"].get(kernel, 0),
            # rank 0 of the (2, 2) mesh: the bf16 zamba2, qwen3-moe and
            # seamless prefill + decode on its local heads
            "mesh_launches": sum(mesh_launches[m].get(kernel, 0)
                                 for m in ("zamba2", "moe", "encdec")),
            # the timed local-head shapes of a (2, 2) mesh rank
            "mesh_shapes": [{k: r.get(k) for k in (
                "case", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "v1_ms", "v2_ms", "max_abs_err")}
                for r in records[name]
                if "mesh rank" in r["case"] and "ms" in r],
            # rank 0 of the (2, 2) train mesh: the bf16 13-layer zamba2's
            # timed steps (forward and recompute on its local heads), and
            # the one-device qwen3-moe train steps
            "mesh_train_launches": mesh_train["mesh"].get(kernel, 0),
            "mesh_train_launches_per_step":
                mesh_train["per_step"].get(kernel, 0),
            "moe_train_launches": mesh_train["moe"]["launches"].get(
                kernel, 0),
            "mesh_train_shapes": [{k: r.get(k) for k in (
                "case", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "v1_ms", "v2_ms", "max_abs_err")}
                for r in records[name]
                if "mesh train rank" in r["case"] and "ms" in r]})
    log(f"[time] whole script {time.perf_counter() - t_main:.1f}s")
    print(card(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
