"""Dry run: trace every (arch x shape x mesh) cell on meta tensors.

Counterpart of `repro.launch.dryrun`.  The reference lowers and compiles
each cell for 256 / 512 placeholder TPU devices; the port runs one
rank's real step (`make_train_step` / `make_prefill_step` /
`make_decode_step`, the kernels' custom ops included) on meta tensors
under a fake process group of the mesh's world size
(``dist.init_process_group("fake", ...)``), so nothing is allocated and
no collective moves: each collective is counted on the route it models
(`parallel.collectives.FAKE_ROUTE`, "nccl" by default here) and the
step's ops are counted by `launch.op_analysis`.

Meshes are the port's production meshes of 8-card nodes
(`launch.mesh.make_production_mesh`): 256 ranks as (32 data, 8 model),
named ``32x8``, and 512 as (2 pod, 16 data, 8 model), ``2x16x8``.

The inputs are this rank's blocks (`launch.specs`), the batch the whole
batch, as the port's steps take it (each rank cuts its rows).  A record
holds ``memory`` (the arguments' bytes as blocks, the outputs' bytes and
the step's ``peak_bytes`` a rank), the ``analysis`` and ``wall_s``.  A
train cell whose config sets no micro-steps takes the fewest of 1, 2,
4, ... whose ``peak_bytes`` fits in the card's memory
(`launch.mesh.HARDWARE["hbm_bytes"]`); the reference's rule (2 for
``d_model >= 3584``) is a 16 GB TPU chip's.

Usage (on the CPU: meta tensors need no card):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch zamba2-7b \\
      --shape train_4k [--multi-pod] [--out build/repro_torch/dryrun]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Optional, Tuple

from repro_torch.configs.base import (ARCH_IDS, SHAPES, ModelConfig,
                                      ShapeConfig, get_config)
from repro_torch.launch.mesh import HARDWARE

OUT_DIR = os.path.join("build", "repro_torch", "dryrun")


def cell_is_skipped(arch: str, shape_name: str) -> str:
    """Returns a reason string if the cell is skipped, else ''."""
    cfg = get_config(arch)
    if shape_name == "long_500k" and not cfg.subquadratic:
        return ("full-attention arch: 500k decode requires sub-quadratic "
                "attention")
    return ""


VARIANTS = {
    "baseline": {},
    "tp_sp": {"tp_sp": True},
    "pad_heads": {"pad_attn_heads": True},
    "tp_sp+pad": {"tp_sp": True, "pad_attn_heads": True},
    "moe_int8": {"moe_a2a_int8": True},
    "remat_dots": {"remat": "dots"},
    "flash_full": {"attn_impl": "full"},   # materialised scores
    "tp_sp+moe_int8": {"tp_sp": True, "moe_a2a_int8": True},
    "tp_sp+remat_dots": {"tp_sp": True, "remat": "dots"},
}


def fake_group(world: int) -> None:
    """This process as rank 0 of a fake process group of ``world`` ranks
    (a group of another size or backend is torn down first)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.parallel import collectives
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            return
        dist.destroy_process_group()
        collectives._GROUPS.clear()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def mesh_name(shape: Tuple[int, ...]) -> str:
    return "x".join(str(n) for n in shape)


def make_mesh(multi_pod: bool = False, shape: Optional[Tuple[int, int]]
              = None):
    """The production mesh on a fake group of its size, or with ``shape``
    a (data, model) host mesh of that many ranks."""
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    if shape is not None:
        fake_group(shape[0] * shape[1])
        return make_host_mesh(*shape)
    fake_group(512 if multi_pod else 256)
    return make_production_mesh(multi_pod=multi_pod)


def _nbytes(tree) -> int:
    import torch
    from torch.utils._pytree import tree_flatten
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
               route: Optional[str] = None, *,
               cache_len: Optional[int] = None, opt=None) -> dict:
    """One rank's step of the cell on meta tensors under the fake group
    of ``mesh`` (None: one device; ``route``: the collectives' modelled
    backend, the current `FAKE_ROUTE` by default; ``cache_len`` the
    caches' length, `launch.specs`'; ``opt`` the train step's
    `AdamWConfig`, the default one by default).  {"memory",
    "analysis"}."""
    from repro_torch.launch.op_analysis import analyze_step
    from repro_torch.launch.specs import batch_specs, step_args_abstract
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel import collectives
    from repro_torch.training.train_state import (make_decode_step,
                                                  make_prefill_step,
                                                  make_train_step)
    args = step_args_abstract(cfg, shape, mesh, cache_len)
    call = list(args)
    call[1] = batch_specs(cfg, shape)
    if shape.kind == "train":
        step = make_train_step(cfg, opt or AdamWConfig(), mesh)
    elif shape.kind == "prefill":
        step = make_prefill_step(cfg, mesh)
    else:
        step = make_decode_step(cfg, mesh)
    world = 1 if mesh is None else mesh.size()
    old = collectives.FAKE_ROUTE
    collectives.FAKE_ROUTE = route or old
    try:
        analysis = analyze_step(step, *call, n_devices=world)
    finally:
        collectives.FAKE_ROUTE = old
    return {"memory": {"argument_bytes": _nbytes(args),
                       "output_bytes": analysis.pop("output_bytes"),
                       "peak_bytes": analysis["peak_bytes"]},
            "analysis": analysis}


def _micro_choices(shape: ShapeConfig, mesh):
    """1, 2, 4, ... while each micro-batch leaves every rank a row."""
    from repro_torch.parallel.sharding import (DEFAULT_RULES, axis_sizes,
                                               logical_to_mesh_axes,
                                               entry_axes)
    rows = shape.global_batch
    if mesh is not None:
        axes = entry_axes(logical_to_mesh_axes(
            mesh, (shape.global_batch,), ("batch",), DEFAULT_RULES)[0])
        sizes = axis_sizes(mesh)
        for a in axes:
            rows //= sizes[a]
    m = 1
    while m <= rows and rows % m == 0:
        yield m
        m *= 2


def lower_cell_config(arch: str, variant: str = "baseline",
                      reduced: bool = False) -> ModelConfig:
    """The cell's config: the kernels on (``use_pallas``), the variant's
    overrides, ``reduced_config`` with ``reduced``."""
    from repro_torch.configs.base import reduced_config
    cfg = get_config(arch)
    if reduced:
        cfg = reduced_config(cfg)
    return cfg.replace(use_pallas=True, **VARIANTS[variant])


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             out_dir: Optional[str] = None, verbose: bool = False,
             variant: str = "baseline", *, mesh_shape=None,
             reduced: bool = False, shape: Optional[ShapeConfig] = None,
             route: str = "nccl") -> dict:
    """Trace one cell; its record (``status`` ok / skipped / error).
    ``mesh_shape`` (data, model), ``reduced`` and ``shape`` (a
    `ShapeConfig` of another size under ``shape_name``) cut a cell to a
    test's size."""
    t0 = time.time()
    reason = cell_is_skipped(arch, shape_name)
    mesh_label = (mesh_name(mesh_shape) if mesh_shape else
                  "2x16x8" if multi_pod else "32x8")
    rec = {"arch": arch, "shape": shape_name, "variant": variant,
           "mesh": mesh_label, "route": route}
    if reason:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return rec
    try:
        cfg = lower_cell_config(arch, variant, reduced)
        shape = shape or SHAPES[shape_name]
        mesh = make_mesh(multi_pod, mesh_shape)
        micro = (list(_micro_choices(shape, mesh))
                 if shape.kind == "train" and cfg.micro_steps == 1
                 else [cfg.micro_steps])
        for m in micro:
            out = trace_cell(cfg.replace(micro_steps=m), shape, mesh, route)
            if out["memory"]["peak_bytes"] <= HARDWARE["hbm_bytes"]:
                break
        if verbose:
            print(out["memory"], {k: out["analysis"][k] for k in
                                  ("flops", "bytes_accessed")})
        rec.update({"status": "ok", "micro_steps": m,
                    "fits": out["memory"]["peak_bytes"]
                    <= HARDWARE["hbm_bytes"], **out})
    except Exception as e:  # noqa: BLE001 — the sweep records failures
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["wall_s"] = round(time.time() - t0, 1)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = "" if variant == "baseline" else f"__{variant}"
        fn = os.path.join(out_dir,
                          f"{arch}__{shape_name}__{rec['mesh']}{suffix}.json")
        with open(fn, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--variant", default="baseline", choices=list(VARIANTS))
    ap.add_argument("--route", default="nccl", choices=["nccl", "gloo"])
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for arch in ARCH_IDS:
            for shape in SHAPES:
                cells.append((arch, shape))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells.append((args.arch, args.shape))

    ok = True
    t0 = time.time()
    for arch, shape in cells:
        rec = run_cell(arch, shape, args.multi_pod, args.out,
                       variant=args.variant, route=args.route)
        status = rec["status"]
        extra = ""
        if status == "ok":
            a = rec["analysis"]
            extra = (f"flops/dev={a['flops']:.3e} "
                     f"coll={a['collective_bytes']:.3e}B "
                     f"args={rec['memory']['argument_bytes'] / 2**30:.2f}GiB "
                     f"peak={rec['memory']['peak_bytes'] / 2**30:.2f}GiB "
                     f"micro={rec['micro_steps']} {rec['wall_s']}s")
        elif status == "error":
            ok = False
            extra = rec["error"][:200]
        print(f"[{status:7s}] {arch:24s} {shape:12s} {rec['mesh']:8s} {extra}",
              flush=True)
    print(f"[dryrun] {len(cells)} cells in {time.time() - t0:.1f}s",
          flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
