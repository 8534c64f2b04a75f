"""What every kernel wrapper of the port does around its launch: decide
the path from the tensors' device, check what the kernel takes, launch on
the current stream and raise on a CUDA error."""
from __future__ import annotations

from typing import Iterable, Sequence, Union

import torch

FLOAT_TYPES = (torch.float32, torch.bfloat16, torch.float16)
# dtype code shared with csrc/*.cu (0 f32, 1 bf16, 2 f16)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the dtypes that flash_fwd_launch sends to the tensor-core kernel (f32
# runs on the CUDA cores; ssd_scan_launch sends bf16 alone there)
MMA_TYPES = (torch.bfloat16, torch.float16)


def _device_kind(tensors, allowed) -> str:
    kinds = {t.device.type for t in tensors if t is not None}
    if len(kinds) > 1:
        raise ValueError(f"tensors on mixed devices: {sorted(kinds)}")
    kind = kinds.pop() if kinds else "cpu"
    if kind not in allowed:
        raise ValueError(f"unsupported device type {kind!r}: "
                         "repro_torch runs on 'cuda' or 'cpu'")
    return kind


def on_card(*tensors: torch.Tensor) -> bool:
    """True when the tensors lie on a CUDA device, False on the CPU.
    Mixed devices and any other device type raise."""
    return _device_kind(tensors, ("cuda", "cpu")) == "cuda"


def kernel_op(*tensors: torch.Tensor) -> bool:
    """`on_card` for a kernel that is also a `torch.library.custom_op`
    (`flash_fwd`, `ssd_scan`): True on CUDA (the op launches the kernel)
    and on meta (the op's registered fake gives outputs of the right
    shape and dtype and computes nothing, so a step traces on meta
    tensors with the kernel's work counted: `launch.op_analysis`), False
    on the CPU.  Any other device raises."""
    return _device_kind(tensors, ("cuda", "cpu", "meta")) != "cpu"


def lib():
    from repro_torch import kernels_build
    return kernels_build.load()


def require(t: torch.Tensor, name: str,
            dtypes: Union[torch.dtype, Iterable[torch.dtype]],
            shape: Sequence[int]) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of one of ``dtypes``
    and of ``shape``."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, "
                         f"got {t.device}")
    allowed = (dtypes,) if isinstance(dtypes, torch.dtype) else tuple(dtypes)
    if t.dtype not in allowed:
        raise TypeError(f"{name}: expected {allowed}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise when grad mode is on and an input requires grad: a launch's
    outputs carry no grad_fn, so autograd would drop every gradient
    upstream of it without a word.  Inside an autograd.Function's forward
    grad mode is off, and the launch goes ahead."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad outside its autograd.Function; "
            "the kernel's outputs would carry no gradient")


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
