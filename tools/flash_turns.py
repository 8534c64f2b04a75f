"""Check and time `flash_fwd` on the card: the quick loop for work on its
kernels, without the rest of `chip_smoke.py`.

    python3 tools/flash_turns.py [--sass DIR]

Builds the port's kernels (printing what `ptxas -v` says of the wgmma
kernel), holds `flash_fwd` against its plain version in bf16 and f16 on
edge shapes and on the main paths' shapes with the route each takes,
then times, at the six main-path shapes, the wgmma kernel (v3) in turns
against the mma.sync kernel (`flash_fwd_v2`: v2, v3, v3, v2) beside
`scaled_dot_product_attention`, each a CUDA-graph replay between CUDA
events.  Each step runs in a child process under a time limit, so a
kernel that hangs is killed.  With ``--sass DIR`` it also writes the
wgmma kernel's SASS (`cuobjdump`) to DIR/flash_fwd_wgmma.sass.  Needs
a CUDA card and nvcc; exits non-zero when a case disagrees.
"""
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# B, Sq, Skv, Hq, Hkv, D, causal, window: wgmma's edges (a padded box,
# ragged rows past a 128-row tile, GQA, windows, Sq != Skv with a wholly
# masked tail), then the main paths' shapes
CASES = [
    (1, 128, 128, 1, 1, 64, False, 0),
    (2, 128, 128, 4, 2, 32, True, 0),
    (1, 100, 100, 4, 4, 16, True, 0),
    (2, 128, 128, 8, 2, 32, True, 24),
    (2, 64, 128, 4, 2, 16, False, 0),
    (2, 130, 130, 4, 2, 8, True, 0),
    (2, 200, 200, 8, 2, 112, True, 0),
    (1, 190, 190, 8, 2, 64, True, 40),
    (1, 300, 150, 4, 1, 40, False, 17),
    (1, 150, 300, 4, 1, 120, False, 100),
    (1, 1000, 1000, 2, 1, 128, True, 0),
    (4, 2048, 2048, 32, 32, 112, True, 0),
    (4, 2048, 2048, 32, 4, 128, True, 0),
    (4, 2048, 2048, 16, 16, 64, False, 0),
]
# B, Hq, Hkv, D, causal, what (S = 2048)
SHAPES = [
    (4, 32, 32, 112, True, "zamba2 prefill"),
    (4, 32, 4, 128, True, "qwen3-moe prefill"),
    (4, 16, 16, 64, False, "seamless encoder"),
    (2, 16, 16, 112, True, "zamba2, a (2, 2) serve rank"),
    (2, 16, 2, 128, True, "qwen3-moe, a (2, 2) serve rank"),
    (1, 16, 16, 112, True, "zamba2, a (2, 2) train rank"),
]


def device_ms(torch, fn, reps=10, inner=3):
    """Median device ms of one call: `inner` calls in a CUDA graph
    replayed `reps` times between CUDA events."""
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


def build():
    from repro_torch import kernels_build
    t0 = time.perf_counter()
    kernels_build.load()
    print(f"build {time.perf_counter() - t0:.1f}s", flush=True)
    for line in kernels_build.BUILD_INFO["log"].splitlines():
        if "flash_fwd_wgmma" in line or "C751" in line:
            print("  " + line.strip()[:240], flush=True)
    return kernels_build.BUILD_INFO["path"]


def check(torch):
    import numpy as np
    from repro_torch.kernels.flash_attention import kernel as fk
    rs = np.random.default_rng(7)
    bad = 0
    for case in CASES:
        B, Sq, Skv, Hq, Hkv, D, causal, window = case
        for dtype in (torch.bfloat16, torch.float16):
            q, k, v = (torch.from_numpy(rs.standard_normal(s).astype(
                np.float32)).cuda().to(dtype) for s in (
                    (B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
            n0 = dict(fk.LAUNCHES)
            out, lse = fk.flash_fwd(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            route = [r for r in ("wgmma", "mma")
                     if fk.LAUNCHES[f"flash_fwd.{r}"] > n0[f"flash_fwd.{r}"]]
            want, wlse = fk.flash_fwd_plain(q, k, v, causal=causal,
                                            window=window)
            live = wlse > -1e29      # rows with a key alive under the mask
            err = float((out.float() - want.float())[live].abs().max()) \
                if bool(live.any()) else 0.0
            lerr = float((lse - wlse)[live].abs().max()) \
                if bool(live.any()) else 0.0
            ok = (err < 2e-2 and lerr < 2e-2 and route == ["wgmma"]
                  and bool(torch.equal(live, lse > -1e29))
                  and bool(torch.isfinite(out).all()))
            bad += not ok
            print(f"{'ok ' if ok else 'BAD'} {case} {dtype}: out {err:.3e} "
                  f"lse {lerr:.3e} route {route}", flush=True)
    return bad


def timing(torch):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fk
    S = 2048
    for B, Hq, Hkv, D, causal, what in SHAPES:
        q = torch.randn((B, S, Hq, D), device="cuda", dtype=torch.bfloat16)
        k, v = (torch.randn((B, S, Hkv, D), device="cuda",
                            dtype=torch.bfloat16) for _ in range(2))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        v3 = lambda: fk.flash_fwd(q, k, v, causal=causal)  # noqa: E731
        v2 = lambda: fk.flash_fwd_v2(q, k, v, causal=causal)  # noqa: E731
        turns = [device_ms(torch, f) for f in (v2, v3, v3, v2)]
        sdpa = device_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=Hq != Hkv))
        flop = 4 * B * Hq * D * fk.live_pairs(S, S, causal, 0)
        bound = flop / 989e12 * 1e3
        ms = (turns[1] + turns[2]) / 2
        print(f"{what}: v2 {turns[0]:.4f} / {turns[3]:.4f}, v3 "
              f"{turns[1]:.4f} / {turns[2]:.4f}, SDPA {sdpa:.4f}, bound "
              f"{bound:.4f} ms ({bound / ms:.3f} of it, "
              f"{flop / ms / 1e9:.0f} TFLOP/s)", flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("flash_turns: torch finds no CUDA device")
    step = sys.argv[1] if len(sys.argv) > 1 else ""
    if step == "--check":
        build()
        sys.exit(1 if check(torch) else 0)
    if step == "--time":
        build()
        timing(torch)
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          flush=True)
    lib = build()
    if step == "--sass":
        out = Path(sys.argv[2])
        out.mkdir(parents=True, exist_ok=True)
        from repro_torch.kernels_build import find_nvcc
        cuobjdump = Path(find_nvcc()).parent / "cuobjdump"
        sass = subprocess.run([str(cuobjdump), "-sass", lib],
                              capture_output=True, text=True).stdout
        keep = [f for f in sass.split("\n\t\tFunction : ")
                if "flash_fwd_wgmma_kernel" in f.split("\n")[0]]
        (out / "flash_fwd_wgmma.sass").write_text(
            "\n\t\tFunction : ".join(keep))
    for child, limit in (("--check", 300), ("--time", 300)):
        r = subprocess.run(["timeout", "-k", "5", str(limit),
                            sys.executable, __file__, child],
                           env=dict(os.environ))
        if r.returncode != 0:
            sys.exit(f"flash_turns: {child} exited {r.returncode}")


if __name__ == "__main__":
    main()
