"""Gradient compression for cross-pod (DCN) reduction.

Two schemes, both with error feedback so compression noise does not bias
the long-run gradient:

  * int8 stochastic-free symmetric quantisation (per-leaf scale)  — 4x
  * top-k magnitude sparsification (per-leaf)                     — ~d/k x

Counterpart of `repro.optim.compression`, on nested dicts of tensors:
`torch.topk` stands for `jax.lax.top_k`, and the reference's tie rule is
kept (every entry whose magnitude is ``>=`` the k-th largest survives).
On a mesh each leaf is a rank's block and both schemes act on the whole
leaf, as the reference's do on its global arrays.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch


def quantize_int8(x: torch.Tensor, axes=(), mesh=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 with one scale for the whole leaf: under ``mesh``
    ``x`` is a block of a leaf cut over ``axes``, and its max|x| a pmax
    over them (no axes: the identity)."""
    from repro_torch.parallel.collectives import pmax
    scale = torch.clamp(pmax(torch.max(torch.abs(x)), axes, mesh),
                        min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def topk_sparsify(x: torch.Tensor, k_frac: float, axes=(), mesh=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the top k_frac fraction by magnitude; returns (values, mask).
    Under ``mesh`` ``x`` is a block of a leaf cut over ``axes``: the
    threshold is the whole leaf's k-th magnitude (its magnitudes
    gathered over them; no axes: the identity)."""
    from repro_torch.parallel.collectives import all_gather
    mags = all_gather(torch.abs(x).reshape(-1), axes, mesh)
    k = max(1, int(mags.numel() * k_frac))
    thresh = torch.topk(mags, k).values[-1]
    mask = (torch.abs(x) >= thresh).to(x.dtype)
    return x * mask, mask


@dataclass(frozen=True)
class CompressionConfig:
    scheme: str = "int8"          # "none" | "int8" | "topk"
    topk_frac: float = 0.01
    error_feedback: bool = True


def compress_leaf(g: torch.Tensor, err: Optional[torch.Tensor],
                  cfg: CompressionConfig, mesh=None, axes=()
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (compressed-then-decompressed gradient, new error state).

    The decompressed value is what enters the cross-pod reduction; error
    feedback accumulates what was lost locally and re-injects it next
    step.  Under ``mesh`` ``g`` is this rank's block of a leaf cut over
    ``axes``: the int8 scale is the whole leaf's max|g| (a pmax), and
    top-k keeps the whole leaf's k largest (its magnitudes gathered)."""
    if cfg.scheme == "none" or g.ndim == 0:
        return g, torch.zeros_like(g)
    gf = g.float()
    if err is not None and cfg.error_feedback:
        gf = gf + err
    if cfg.scheme == "int8":
        deq = dequantize_int8(*quantize_int8(gf, axes, mesh))
    elif cfg.scheme == "topk":
        deq, _ = topk_sparsify(gf, cfg.topk_frac, axes, mesh)
    else:
        raise ValueError(cfg.scheme)
    new_err = (gf - deq) if cfg.error_feedback else torch.zeros_like(gf)
    return deq.to(g.dtype), new_err


def compress_tree(grads, err_tree, cfg: CompressionConfig, mesh=None,
                  leaf_axes=None, prefix: str = ""):
    """(compressed grads, new error tree), both with ``grads``' nesting.
    Under ``mesh`` the leaves are this rank's blocks, cut over
    ``leaf_axes[path]``."""
    if isinstance(grads, dict):
        outs = {k: compress_tree(v, None if err_tree is None
                                 else err_tree[k], cfg, mesh, leaf_axes,
                                 f"{prefix}.{k}" if prefix else k)
                for k, v in grads.items()}
        return ({k: o[0] for k, o in outs.items()},
                {k: o[1] for k, o in outs.items()})
    axes = leaf_axes[prefix] if mesh is not None else ()
    return compress_leaf(grads, err_tree, cfg, mesh, axes)


def compression_ratio(cfg: CompressionConfig) -> float:
    if cfg.scheme == "int8":
        return 4.0
    if cfg.scheme == "topk":
        return 1.0 / max(cfg.topk_frac * 2, 1e-9)   # values + indices
    return 1.0
