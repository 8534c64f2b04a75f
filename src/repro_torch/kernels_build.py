"""Build and load the port's hand-written CUDA kernels.

The sources under `csrc/` (`swarm_kernels.cu`; `flash_fwd.cu` and
`ssd_scan.cu`, the CUDA-core kernels and the C entry points;
`flash_fwd_wgmma.cu` and `ssd_scan_wgmma.cu`, the flash kernel for bf16
and f16 and the SSD kernel for bf16 on wgmma and TMA at the shapes a
tensor map takes, with `wgmma_sm90.cuh`; `flash_fwd_mma.cu` and
`ssd_scan_mma.cu`, the mma.sync kernels for the other 16-bit shapes, with
`mma_sm90.cuh`) are compiled by `nvcc` for Hopper (`sm_90a`), one `nvcc`
per source all started together, and linked into one shared library with
a plain C interface under ``build/repro_torch/`` at the repository root,
at first use, and loaded with ctypes.  The library's file name carries a
hash of the sources and the flags, so an edited source is rebuilt and a
stale library is never loaded.  A failed build raises: nothing falls back
to the plain PyTorch versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent
SOURCES = tuple(_PKG / "csrc" / name for name in
                ("swarm_kernels.cu", "flash_fwd.cu", "ssd_scan.cu",
                 "flash_fwd_wgmma.cu", "flash_fwd_mma.cu",
                 "ssd_scan_wgmma.cu", "ssd_scan_mma.cu"))
HEADERS = tuple(_PKG / "csrc" / name for name in
                ("mma_sm90.cuh", "wgmma_sm90.cuh"))
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
BUILD_INFO = {"seconds": None, "path": None, "log": ""}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "rarest_keys_launch": (_P, _P, _P, _P, ctypes.c_longlong, _I, _I, _P,
                           _P),
    "rarest_orders_launch": (_P, _P, _P, _P, ctypes.c_longlong, _I, _I, _P,
                             _P),
    "island_has_launch": (_P, _P, _I, _I, _I, _P, _P),
    "island_cost_rows_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _P, _P),
    "match_requests_launch": (_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                              _I, _I, _I, _P, _P, _P),
    "flash_fwd_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                         _I, ctypes.c_float, _P),
    "ssd_scan_launch": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _I, _I, _P),
}
_SIGNATURES["flash_fwd_v1_launch"] = _SIGNATURES["flash_fwd_launch"]
_SIGNATURES["flash_fwd_v2_launch"] = _SIGNATURES["flash_fwd_launch"]
_SIGNATURES["ssd_scan_v1_launch"] = _SIGNATURES["ssd_scan_launch"]
_SIGNATURES["ssd_scan_v2_launch"] = _SIGNATURES["ssd_scan_launch"]


def find_nvcc() -> Optional[str]:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    return str(default) if default.exists() else None


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(nvcc: Optional[str] = None,
          build_dir: Optional[Path] = None) -> Path:
    """Compile the kernel library (or reuse a build of the same sources)
    and return its path.  Raises RuntimeError when nvcc is missing or the
    compile fails."""
    nvcc = nvcc or find_nvcc()
    if nvcc is None or not Path(nvcc).exists():
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of repro_torch are built "
            "from csrc/ with nvcc for sm_90a")
    out_dir = Path(build_dir) if build_dir is not None else BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"librepro_torch_kernels_{_digest()}.so"
    log_file = lib.with_suffix(".log")     # nvcc's and ptxas's output
    if lib.exists():
        BUILD_INFO.update(seconds=0.0, path=str(lib),
                          log=log_file.read_text() if log_file.exists()
                          else "cached")
        return lib
    tag = f"{_digest()}.{os.getpid()}"
    objs = [out_dir / f"{src.stem}.{tag}.o" for src in SOURCES]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(SOURCES, objs)]
    logs = [p.communicate()[0] for p in procs]
    try:
        for src, p, out in zip(SOURCES, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} "
                                   f"({p.returncode}):\n{out}")
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
        log = "\n".join(out.strip() for out in logs)
        log_file.write_text(log)
        os.replace(tmp, lib)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, path=str(lib),
                      log=log)
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
