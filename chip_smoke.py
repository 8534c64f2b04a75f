#!/usr/bin/env python3
"""Smoke run of `repro_torch` on one CUDA card (an H100).

    python3 chip_smoke.py

1. builds the port's CUDA kernels (`src/repro_torch/csrc/`) with nvcc
   into `build/repro_torch/`;
2. holds each kernel (`rarest_keys`, `island_has`, `match_requests`)
   against its plain PyTorch version on CUDA tensors at the main path's
   shapes, exactly, and times it on the card;
3. drives the main path — the batched flash-crowd loop, Scenario VII at
   N=2000 and Scenario IX at N=500 with 8 islands (both arms) — on the
   card, checks that every kernel launched during it, and checks every
   virtual-time result against `src/repro_torch/reference_runs.json`
   (the reference package's values under PYTHONHASHSEED=0);
4. prints the per-kernel JSON line, the card's name and power limit, and
   as the last line `{"ok": true, "device": {...}}`.

Any failure exits non-zero without the last line.  The protocol iterates
sets of node names, so the script re-executes itself under
PYTHONHASHSEED=0, the seed the expected values were taken under.
"""
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
RUNS_FILE = SRC / "repro_torch" / "reference_runs.json"
CHIP_RUNS = ("vii_n2000", "ix_n500_i8")
METRICS = ("events", "makespan_s", "full_replication_s", "p99_completion_s",
           "cross_isp_bytes", "origin_up_mb", "replicas")
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
INT_OPS_PER_S = 67e12           # non-tensor-core rate (the fp32 table row)
KERNEL_SOURCE = "src/repro_torch/csrc/swarm_kernels.cu"
REPLACES = {
    "rarest_keys": "src/repro/core/swarm_kernels.py:112",
    "island_has": "src/repro/core/swarm_kernels.py:221",
    "match_requests": "src/repro/core/swarm_kernels.py:487",
}


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

    # ---- rarest_keys (+ stable sort = rarest_orders / cost_orders) ------ #
    R, P = 2000, 64
    counts = up(rs.integers(0, 2001, P).astype(np.int64))
    offsets = up(rs.integers(0, 60_000, R).astype(np.int64))
    missing = up((rs.random((R, P)) < 0.6).astype(np.uint8))
    cost = up(rs.choice(np.array([0, 1, 7, 15, 64]), (R, P))
              .astype(np.int64))
    span = (int(counts.max().item()) + 1) * P * P
    for case, pc, sp in (("R=2000 P=64", None, 0),
                         ("R=2000 P=64 cost", cost, span)):
        got = sk.rarest_keys(counts, offsets, P, missing=missing,
                             piece_cost=pc, span=sp)
        want = sk.rarest_keys_plain(counts, offsets, P, missing=missing,
                                    piece_cost=pc, span=sp)
        if not torch.equal(sk._argsort_rows(got), sk._argsort_rows(want)):
            fail(f"rarest orders [{case}] disagree")
        ins = [counts, offsets, missing] + ([pc] if pc is not None else [])
        check("rarest_keys", case, got, want, nbytes(*ins, got),
              R * P * (8 if pc is None else 10),
              lambda pc=pc, sp=sp: sk.rarest_keys(
                  counts, offsets, P, missing=missing, piece_cost=pc,
                  span=sp),
              lambda pc=pc, sp=sp: sk.rarest_keys_plain(
                  counts, offsets, P, missing=missing, piece_cost=pc,
                  span=sp))

    # ---- island_has ----------------------------------------------------- #
    for N, K in ((500, 8), (2000, 8)):
        have = up((rs.random((N, P)) < 0.05).astype(np.uint8))
        isl = rs.integers(0, K, N)
        member = np.zeros((K, N), dtype=np.uint8)
        member[isl, np.arange(N)] = 1
        member = up(member)
        got = sk.island_has(have, member)
        want = sk.island_has_plain(have, member)
        hf, mf = have.float(), member.float()
        check("island_has", f"N={N} K={K} P={P}", got, want,
              nbytes(have, member, got), K * N * P * 2,
              lambda h=have, m=member: sk.island_has(h, m),
              lambda h=have, m=member: sk.island_has_plain(h, m),
              library=lambda h=hf, m=mf: (m @ h) > 0)

    # ---- match_requests ------------------------------------------------- #
    N = 2000
    have = up((rs.random((N, P)) < 0.3).astype(np.uint8))
    full = up((rs.random(N) < 0.01).astype(np.uint8))
    rank = rs.permutation(N)
    orders = up(np.stack([rs.permutation(P) for _ in range(R)])
                .astype(np.int32))
    n_walk = up(rs.integers(0, P + 1, R).astype(np.int32))
    budgets = up(rs.integers(0, 5, R).astype(np.int32))
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
        # data-dependent work: the steps this data walks, each testing
        # every candidate of the row
        steps = int(torch.minimum(n_walk, torch.full_like(n_walk, P))
                    .sum().item())
        check("match_requests", f"R={R} P={P} C={C} N={N}", got, want,
              nbytes(orders, n_walk, budgets, cand, cand_ok, key, have,
                     full, got), steps * C * 4,
              lambda a=args: sk.match_requests(*a),
              lambda a=args: sk.match_requests_plain(*a))
    return records


# ======================== end-to-end phase ============================== #
def summarize(scenario, res):
    if scenario == "scenario_vii":
        return {k: res[k] for k in METRICS}
    return {arm: {k: res[arm][k] for k in METRICS} for arm in ("naive", "p4p")}


def end_to_end_phase(torch, sk, scenarios):
    golden = json.loads(RUNS_FILE.read_text())
    if golden.get("pythonhashseed") != os.environ.get("PYTHONHASHSEED"):
        fail("expected values were taken under another PYTHONHASHSEED")
    for name in CHIP_RUNS:
        entry = golden["runs"][name]
        run = getattr(scenarios, entry["scenario"])
        before = dict(sk.LAUNCHES)
        t0 = time.perf_counter()
        res = run(verbose=False, device="cuda", **entry["params"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        arms = [res] if entry["scenario"] == "scenario_vii" \
            else [res["naive"], res["p4p"]]
        if not (res["done"] and res["replicated"]):
            fail(f"{name}: done={res['done']} "
                 f"replicated={res['replicated']}")
        if not all(a["device"].startswith("cuda") for a in arms):
            fail(f"{name}: ran on {[a['device'] for a in arms]}")
        got = summarize(entry["scenario"], res)
        launched = {k: sk.LAUNCHES[k] - before[k] for k in sk.LAUNCHES}
        log(f"[e2e] {name} {json.dumps(entry['params'])}: wall_s={wall:.3f} "
            + " | ".join(
                f"events={a['events']} events_per_sec="
                f"{a['events_per_sec']:.1f} tick_wall_s="
                f"{a['tick_wall_s']:.3f} kernel_wall_s="
                f"{a['kernel_wall_s']:.3f} drain_wall_s="
                f"{a.get('drain_wall_s', float('nan')):.3f}" for a in arms)
            + f" launches={json.dumps(launched)}")
        log(f"[e2e] {name} result {json.dumps(got)}")
        if got != entry["result"]:
            log(f"[e2e] {name} MISMATCH against reference_runs.json: "
                f"expected {json.dumps(entry['result'])}")
            cpu = summarize(entry["scenario"],
                            run(verbose=False, device="cpu",
                                **entry["params"]))
            log(f"[e2e] {name} port on the CPU "
                + ("matches" if cpu == entry["result"] else
                   f"does not match either: {json.dumps(cpu)}"))
            fail(f"{name}: card results differ from reference_runs.json")


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
    end_to_end_phase(torch, sk, scenarios)
    launches = dict(sk.LAUNCHES)
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    log(f"[e2e] launches over the main path: {json.dumps(launches)}")

    kernels = []
    for name in ("rarest_keys", "island_has", "match_requests"):
        rec = records[name][0]
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in records[name]),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"]})
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
