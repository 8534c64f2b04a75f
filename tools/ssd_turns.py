"""Check and time `ssd_scan` on the card: the quick loop for work on its
kernels, without the rest of `chip_smoke.py`.

    python3 tools/ssd_turns.py [--sass DIR]

Builds the port's kernels (printing what `ptxas -v` says of the wgmma SSD
kernel), holds `ssd_scan` against its plain version in bf16 on edge
shapes (one chunk, ragged chunks, rounds of a cluster, G = 2, P and N up
to 128, a misaligned x) and on the main paths' shapes with the route each
takes, then times, at the four main-path shapes, the wgmma kernel (v3) in
turns against the mma.sync kernel (`ssd_scan_v2`: v2, v3, v3, v2), each
a CUDA-graph replay between CUDA events.  Each step runs in a child
process under a time limit, so a kernel that hangs is killed.  With
``--sass DIR`` it also writes the wgmma kernel's SASS (`cuobjdump`) to
DIR/ssd_scan_wgmma.sass.  Needs a CUDA card and nvcc; exits non-zero when
a case disagrees.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

from flash_turns import device_ms  # noqa: E402

# B, S, H, P, G, N, chunk, the route, what
CASES = [
    (1, 1, 2, 64, 1, 64, 256, "wgmma", "S = 1"),
    (1, 100, 2, 16, 1, 16, 256, "wgmma", "one chunk of 128 walked"),
    (1, 200, 2, 64, 1, 64, 64, "wgmma", "ragged, 4 chunks"),
    (2, 320, 4, 32, 2, 16, 64, "wgmma", "G = 2, 5 chunks on 8 blocks"),
    (1, 650, 2, 64, 1, 64, 64, "wgmma", "11 chunks, two rounds"),
    (1, 4096, 4, 64, 1, 64, 256, "wgmma", "S = 4096, two rounds"),
    (1, 300, 2, 128, 1, 128, 128, "wgmma", "P = N = 128"),
    (1, 300, 2, 64, 1, 128, 256, "wgmma", "N = 128 (mamba2)"),
    (1, 300, 2, 128, 1, 64, 256, "wgmma", "P = 128"),
    (1, 500, 2, 24, 1, 40, 192, "wgmma", "P 24, N 40, chunk 192"),
    (2, 300, 4, 64, 1, 64, 50, "mma", "chunk 50"),
    (1, 300, 2, 128, 1, 128, 256, "wgmma", "P = N = 128 at 256"),
    (4, 2048, 112, 64, 1, 64, 256, "wgmma", "zamba2 prefill"),
    (2, 2048, 112, 64, 1, 64, 256, "wgmma", "train step"),
    (2, 2048, 56, 64, 1, 64, 256, "wgmma", "a (2, 2) serve rank"),
    (1, 2048, 56, 64, 1, 64, 256, "wgmma", "a (2, 2) train rank"),
]
# B, H (S = 2048, P = N = 64, G = 1, chunk 256)
SHAPES = [(4, 112, "zamba2 prefill"), (2, 112, "train step"),
          (2, 56, "a (2, 2) serve rank"), (1, 56, "a (2, 2) train rank")]


def inputs(torch, rs, B, S, H, P, G, N, offset=0):
    import numpy as np

    def up(shape, scale=1.0):
        return torch.from_numpy((rs.standard_normal(shape) * scale).astype(
            np.float32)).cuda()
    x = up((B, S, H, P)).bfloat16()
    if offset:
        x = torch.empty(x.numel() + offset, dtype=x.dtype,
                        device="cuda")[offset:].view(x.shape).copy_(x)
    dt = torch.nn.functional.softplus(up((B, S, H))).contiguous()
    A = -torch.exp(up((H,), 0.3))
    return (x, dt, A, up((B, S, G, N), 0.5).bfloat16(),
            up((B, S, G, N), 0.5).bfloat16())


def build():
    from repro_torch import kernels_build
    t0 = time.perf_counter()
    kernels_build.load()
    print(f"build {time.perf_counter() - t0:.1f}s", flush=True)
    lines = kernels_build.BUILD_INFO["log"].splitlines()
    for i, line in enumerate(lines):
        if "Function properties for" in line and "ssd_scan_wgmma" in line:
            print("  " + line.split("kernel")[-1][:16] + ": " + " | ".join(
                x.strip() for x in lines[i + 1:i + 3]), flush=True)
        if "C751" in line:
            print("  " + line.strip()[:240], flush=True)
    return kernels_build.BUILD_INFO["path"]


def check(torch):
    import numpy as np
    from repro_torch.kernels.ssd import kernel as ssk
    rs = np.random.default_rng(7)
    bad = 0
    cases = [c + (0,) for c in CASES] + [
        (2, 300, 4, 64, 1, 64, 256, "mma", "x 2 bytes off 16", 1)]
    for B, S, H, P, G, N, chunk, want, what, offset in cases:
        args = inputs(torch, rs, B, S, H, P, G, N, offset)
        n0 = dict(ssk.LAUNCHES)
        t0 = time.perf_counter()
        y, fin = ssk.ssd_scan(*args, chunk=chunk)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        route = [r for r in ("wgmma", "mma")
                 if ssk.LAUNCHES[f"ssd_scan.{r}"] > n0[f"ssd_scan.{r}"]]
        wy, wfin = ssk.ssd_scan_plain(*args, chunk=chunk)
        ey = float((y.float() - wy.float()).abs().max())
        es = float((fin - wfin).abs().max())
        my = float(wy.float().abs().max())
        ms = float(wfin.abs().max())
        ok = (ey <= 1e-2 * max(my, 1e-30) and es <= 1e-2 * max(ms, 1e-30)
              and route == [want] and bool(torch.isfinite(y).all()))
        bad += not ok
        print(f"{'ok ' if ok else 'BAD'} {(B, S, H, P, G, N, chunk)} {what}: "
              f"y {ey:.3e} of {my:.3f}, state {es:.3e} of {ms:.3f}, route "
              f"{route}, first call {wall * 1e3:.1f} ms", flush=True)
    return bad


def timing(torch):
    import numpy as np
    from repro_torch.kernels.ssd import kernel as ssk
    rs = np.random.default_rng(11)
    S, P, N, chunk = 2048, 64, 64, 256
    for B, H, what in SHAPES:
        args = inputs(torch, rs, B, S, H, P, 1, N)
        v3 = lambda: ssk.ssd_scan(*args, chunk=chunk)  # noqa: E731
        v2 = lambda: ssk.ssd_scan_v2(*args, chunk=chunk)  # noqa: E731
        turns = [device_ms(torch, f) for f in (v2, v3, v3, v2)]
        y, fin = v3()
        n_bytes = sum(t.numel() * t.element_size()
                      for t in (*args, y, fin))
        bound = max(n_bytes / 3.35e12, ssk.ssd_ops(B, S, H, P, N, chunk)
                    / 989e12) * 1e3
        ms = (turns[1] + turns[2]) / 2
        print(f"{what} B={B} H={H}: v2 {turns[0]:.4f} / {turns[3]:.4f}, v3 "
              f"{turns[1]:.4f} / {turns[2]:.4f}, bound {bound:.4f} ms "
              f"(v3 at {bound / ms:.3f} of it)", flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("ssd_turns: torch finds no CUDA device")
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
                if "ssd_scan_wgmma_kernel" in f.split("\n")[0]]
        (out / "ssd_scan_wgmma.sass").write_text(
            "\n\t\tFunction : ".join(keep))
    for child, limit in (("--check", 240), ("--time", 240)):
        r = subprocess.run(["timeout", "-k", "5", str(limit),
                            sys.executable, __file__, child],
                           env=dict(os.environ))
        if r.returncode != 0:
            sys.exit(f"ssd_turns: {child} exited {r.returncode}")


if __name__ == "__main__":
    main()
