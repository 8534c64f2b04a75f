"""The SSD scan behind one call, with the implementation chosen by name.

Counterpart of `repro.kernels.ssd.ops`: ``impl="pallas"`` is the kernel
(`kernels.ssd.kernel.ssd_scan`: the CUDA kernel for CUDA tensors, its plain
version for CPU tensors), anything else the chunked torch scan of
`models.ssm`.
"""
from __future__ import annotations

from typing import Tuple

import torch


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, chunk: int = 128, impl: str = "pallas"
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    if impl == "pallas":
        from repro_torch.kernels.ssd.kernel import ssd_scan
        return ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    from repro_torch.models.ssm import ssd_scan
    return ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
