"""Roofline analysis over the dry-run records, priced on the H100.

Counterpart of `repro.launch.roofline`.  Three terms per (arch x shape)
cell, per rank, in seconds on the port's `launch.mesh.HARDWARE` (H100
SXM):

  compute    = counted FLOPs / peak_flops_bf16          (989 TFLOP/s)
  memory     = counted bytes / hbm_bandwidth            (3.35 TB/s)
  collective = each collective's ring-weighted link bytes at the
               bandwidth of the axes it spans

The one change of design from the reference: the reference prices every
collective on one ICI link, the TPU's.  An H100 mesh has two fabrics, so
a group inside the ``model`` axis, which lies inside a node of 8 cards
(`launch.mesh.make_production_mesh`), crosses NVLink
(``nvlink_bandwidth``), and a group that spans ``data`` or ``pod``
crosses the network (``internode_bandwidth``).

The counted FLOPs and bytes come from `launch.op_analysis` (every op of
the step as it ran, unfused, so the memory term is an upper bound).
MODEL_FLOPS uses the 6ND / 2ND convention (active params for MoE), so the
useful-fraction column shows remat, padding and causal waste.
"""
from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass
from typing import List, Optional

from repro_torch.configs.base import SHAPES, ModelConfig, get_config
from repro_torch.launch.mesh import HARDWARE
from repro_torch.launch.op_analysis import collective_link_bytes

ART_DIR = os.path.join("build", "repro_torch", "dryrun")
INTRA_NODE_AXES = ("model",)


def model_flops(arch: str, shape_name: str) -> float:
    """Global useful flops per step: 6ND train / 2ND inference (+ attention
    term for quadratic-attention archs at long S)."""
    shape = SHAPES[shape_name]
    return model_flops_of(get_config(arch), shape.global_batch,
                          shape.seq_len, shape.kind)


def model_flops_of(cfg: ModelConfig, B: int, S: int, kind: str) -> float:
    """`model_flops` of any config at a global batch ``B`` of sequences
    of ``S`` (the source length of an encoder-decoder), for ``kind`` in
    train / prefill / decode."""
    from repro_torch.models.model import count_params
    n_total = count_params(cfg, include_embed=True,
                           active_only=bool(cfg.num_experts))
    n = n_total - cfg.vocab_size * cfg.d_model   # embedding gather ~free
    if kind == "train":
        tokens = B * (S // cfg.encdec_tgt_ratio if cfg.is_encdec else S)
        base = 6.0 * n * tokens
        # causal attention fwd+bwd ~ 3 x fwd; fwd = 4*B*S^2/2*H*D per layer
        attn = _attn_flops(cfg, B, S) * 3.0
    elif kind == "prefill":
        tokens = B * S
        base = 2.0 * n * tokens
        attn = _attn_flops(cfg, B, S)
    else:  # decode: 1 token per sequence against an S-long cache
        base = 2.0 * n * B
        attn = _decode_attn_flops(cfg, B, S)
    return base + attn


def _layers_of(cfg, kind):
    n = 0
    for g in cfg.groups:
        for ls in g.layers:
            if ls.mixer == kind:
                n += g.repeat
            if ls.shared_attn and kind == "attn":
                n += g.repeat
    return n


def _attn_flops(cfg, B, S):
    if cfg.num_heads == 0:
        return 0.0
    hd = cfg.num_heads * cfg.head_dim
    full = _layers_of(cfg, "attn")
    local = _layers_of(cfg, "attn_local")
    w = min(cfg.window_size, S)
    f = 4.0 * B * (S * S / 2) * hd * full
    f += 4.0 * B * (S * w - w * w / 2) * hd * local
    return f


def _decode_attn_flops(cfg, B, S):
    if cfg.num_heads == 0:
        return 0.0
    hd = cfg.num_heads * cfg.head_dim
    full = _layers_of(cfg, "attn")
    local = _layers_of(cfg, "attn_local")
    return 4.0 * B * (S * full + min(cfg.window_size, S) * local) * hd


def link_bandwidth(axes) -> float:
    """The bandwidth a collective over ``axes`` crosses: NVLink inside a
    node (the ``model`` axis), the network once it spans another axis."""
    if all(a in INTRA_NODE_AXES for a in axes):
        return HARDWARE["nvlink_bandwidth"]
    return HARDWARE["internode_bandwidth"]


def collective_seconds(coll_ops: List[dict]) -> float:
    return sum(collective_link_bytes([op]) / link_bandwidth(op["axes"])
               for op in coll_ops)


def roofline_terms(analysis: dict) -> dict:
    """compute_s, memory_s, collective_s and the dominant term of one
    rank's `op_analysis.analyze_step` result."""
    t = {"compute_s": analysis["flops"] / HARDWARE["peak_flops_bf16"],
         "memory_s": analysis["bytes_accessed"] / HARDWARE["hbm_bandwidth"],
         "collective_s": collective_seconds(analysis.get("coll_ops", []))}
    t["dominant"] = max(("compute", t["compute_s"]), ("memory", t["memory_s"]),
                        ("collective", t["collective_s"]),
                        key=lambda kv: kv[1])[0]
    return t


@dataclass
class CellRoofline:
    arch: str
    shape: str
    mesh: str
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops_dev: float
    hlo_flops_dev: float
    useful_ratio: float
    roofline_fraction: float
    note: str


_NOTES = {
    "compute": ("compute-bound: cut remat recompute / causal-brick padding, "
                "or raise arithmetic intensity with larger per-card tiles"),
    "memory": ("HBM-bound: fuse elementwise chains, keep activations bf16, "
               "shrink remat working set"),
    "collective": ("collective-bound: replace all-reduce with "
                   "reduce-scatter+all-gather (TP-SP), overlap FSDP gathers "
                   "with compute, keep cross-node groups off the network"),
}


def analyze_cell(rec: dict) -> Optional[CellRoofline]:
    if rec.get("status") != "ok":
        return None
    a = rec["analysis"]
    n_dev = a.get("n_devices", 256)
    t = roofline_terms(a)
    peak = HARDWARE["peak_flops_bf16"]
    mf = model_flops(rec["arch"], rec["shape"]) / n_dev
    useful = mf / max(a["flops"], 1.0)
    frac = (mf / peak) / max(t["compute_s"], t["memory_s"],
                             t["collective_s"], 1e-12)
    return CellRoofline(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        compute_s=t["compute_s"], memory_s=t["memory_s"],
        collective_s=t["collective_s"], dominant=t["dominant"],
        model_flops_dev=mf, hlo_flops_dev=a["flops"], useful_ratio=useful,
        roofline_fraction=frac, note=_NOTES[t["dominant"]])


def load_cells(art_dir: str = ART_DIR, mesh: str = "32x8"
               ) -> List[CellRoofline]:
    out = []
    for fn in sorted(glob.glob(os.path.join(art_dir, "*.json"))):
        with open(fn) as f:
            rec = json.load(f)
        if rec.get("mesh") != mesh:
            continue
        if rec.get("variant", "baseline") != "baseline":
            continue   # the variants live in their own section
        cell = analyze_cell(rec)
        if cell:
            out.append(cell)
    return out


def markdown_table(cells: List[CellRoofline]) -> str:
    hdr = ("| arch | shape | compute s | memory s | collective s | bound | "
           "model/counted flops | roofline frac |\n"
           "|---|---|---|---|---|---|---|---|")
    rows = [hdr]
    for c in sorted(cells, key=lambda c: (c.arch, c.shape)):
        rows.append(
            f"| {c.arch} | {c.shape} | {c.compute_s:.3f} | {c.memory_s:.3f} "
            f"| {c.collective_s:.3f} | {c.dominant} | {c.useful_ratio:.2f} "
            f"| {c.roofline_fraction:.3f} |")
    return "\n".join(rows)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--art", default=ART_DIR)
    ap.add_argument("--mesh", default="32x8")
    args = ap.parse_args(argv)
    cells = load_cells(args.art, args.mesh)
    print(markdown_table(cells))
    worst = sorted(cells, key=lambda c: c.roofline_fraction)[:3]
    collb = [c for c in cells if c.dominant == "collective"]
    print("\nworst roofline fractions:",
          [(c.arch, c.shape, round(c.roofline_fraction, 3)) for c in worst])
    print("collective-bound cells:",
          [(c.arch, c.shape) for c in collb][:8])


if __name__ == "__main__":
    main()
