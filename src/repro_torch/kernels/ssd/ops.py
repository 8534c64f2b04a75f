"""The SSD scan behind one call, with the implementation chosen by name.

Counterpart of `repro.kernels.ssd.ops`: ``impl="pallas"`` is the kernel
behind `SSDScan` (`kernels.ssd.kernel.ssd_scan`: the CUDA kernel for CUDA
tensors, its plain version for CPU tensors), anything else the chunked
torch scan of `models.ssm`, which autograd differentiates directly.

`SSDScan` gives the kernel a backward.  The reference defines no VJP for
its Pallas scan; what jax differentiates there is the jnp chunked scan.
So the backward recomputes `models.ssm.ssd_scan` on the saved inputs, in
their dtypes, under grad mode and takes `torch.autograd.grad` of it: the
same gradients as the torch path from the same inputs, under an
``ssd.backward`` span (on autograd's thread).  A gradient of the final
state is taken too (the prefill's state).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.spans import span


class SSDScan(torch.autograd.Function):
    """(y, final_state) = the SSD kernel's scan; saves the inputs."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        from repro_torch.kernels.ssd.kernel import ssd_scan
        y, fin = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, fin

    @staticmethod
    def backward(ctx, dy, dfin):
        from repro_torch.models.ssm import ssd_scan as chunked_scan
        need = ctx.needs_input_grad[:5]
        with torch.enable_grad(), span("ssd.backward"):
            ins = [t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, need)]
            y, fin = chunked_scan(*ins, chunk=ctx.chunk)
            outs = [(o, g) for o, g in ((y, dy), (fin, dfin))
                    if g is not None]
            wrt = [t for t in ins if t.requires_grad]
            grads = iter(torch.autograd.grad(
                [o for o, _ in outs], wrt, [g for _, g in outs],
                allow_unused=True) if outs and wrt else ())
        return (*[next(grads) if n else None for n in need], None)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, chunk: int = 128, impl: str = "pallas"
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    if impl == "pallas":
        return SSDScan.apply(x, dt, A, Bm, Cm, chunk)
    from repro_torch.models.ssm import ssd_scan
    return ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
