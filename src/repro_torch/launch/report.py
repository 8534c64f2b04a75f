"""The dry-run section and the perf rows, as markdown, from the records.

Counterpart of `repro.launch.report`: reads the records that
`launch.dryrun` writes (``build/repro_torch/dryrun`` by default) and
prints the dry-run table, the roofline table of the single-pod mesh and
the variant rows of three cells, every term priced on the H100
(`launch.roofline`).

  PYTHONPATH=src python -m repro_torch.launch.report [--art DIR]
"""
from __future__ import annotations

import glob
import json
import os

from repro_torch.launch.mesh import HARDWARE
from repro_torch.launch.op_analysis import collective_link_bytes
from repro_torch.launch.roofline import (ART_DIR, load_cells, markdown_table,
                                         roofline_terms)


def load(art, arch, shape, mesh="32x8", variant=None):
    suffix = f"__{variant}" if variant else ""
    fn = os.path.join(art, f"{arch}__{shape}__{mesh}{suffix}.json")
    if not os.path.exists(fn):
        return None
    with open(fn) as f:
        return json.load(f)


def terms(rec):
    a = rec["analysis"]
    t = roofline_terms(a)
    return {
        "flops": a["flops"],
        "bytes": a["bytes_accessed"],
        "coll_raw": a["collective_bytes"],
        "coll_link": collective_link_bytes(a.get("coll_ops", [])),
        "compute_s": t["compute_s"],
        "memory_s": t["memory_s"],
        "coll_s": t["collective_s"],
        "peak_gib": rec["memory"]["peak_bytes"] / 2**30,
        "kinds": a.get("collectives", {}),
    }


def dryrun_section(art=ART_DIR) -> str:
    rows = ["| arch | shape | mesh | status | flops/dev | coll B/dev | "
            "args GiB | peak GiB | micro |", "|---|---|---|---|---|---|---|---|---|"]
    for fn in sorted(glob.glob(os.path.join(art, "*.json"))):
        with open(fn) as f:
            rec = json.load(f)
        if rec.get("variant", "baseline") != "baseline":
            continue
        head = f"| {rec['arch']} | {rec['shape']} | {rec['mesh']} "
        if rec["status"] == "ok":
            a = rec["analysis"]
            rows.append(
                head + f"| ok | {a['flops']:.2e} | "
                f"{a['collective_bytes']:.2e} | "
                f"{rec['memory']['argument_bytes'] / 2**30:.2f} | "
                f"{rec['memory']['peak_bytes'] / 2**30:.2f} | "
                f"{rec['micro_steps']} |")
        elif rec["status"] == "skipped":
            rows.append(head + "| skipped | - | - | - | - | - |")
        else:
            rows.append(head + "| ERROR | - | - | - | - | - |")
    return "\n".join(rows)


def perf_row(label, rec):
    t = terms(rec)
    return (f"| {label} | {t['flops']:.3e} | {t['bytes']:.3e} | "
            f"{t['coll_link']:.3e} | {t['compute_s']:.3f} | "
            f"{t['memory_s']:.3f} | {t['coll_s']:.3f} | "
            f"{t['peak_gib']:.1f} |")


PERF_HDR = ("| variant | flops/dev | bytes/dev | coll link-B/dev | "
            "compute s | memory s | coll s | peak GiB |\n"
            "|---|---|---|---|---|---|---|---|")


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--art", default=ART_DIR)
    args = ap.parse_args(argv)
    art = args.art
    print("## Dry run\n")
    print(dryrun_section(art))
    print(f"\n\n## Roofline (single pod 32x8, H100 SXM: "
          f"{HARDWARE['peak_flops_bf16']:.3g} FLOP/s bf16, "
          f"{HARDWARE['hbm_bandwidth']:.3g} B/s HBM)\n")
    print(markdown_table(load_cells(art, "32x8")))
    print("\n\n## Perf cells\n")
    for arch, shape, variants in [
        ("internlm2-20b", "train_4k",
         ["flash_full", None, "tp_sp", "tp_sp+remat_dots"]),
        ("qwen3-14b", "prefill_32k", [None, "pad_heads", "tp_sp+pad"]),
        ("qwen3-moe-30b-a3b", "train_4k",
         [None, "moe_int8", "tp_sp+moe_int8"]),
    ]:
        print(f"### {arch} / {shape}\n")
        print(PERF_HDR)
        for v in variants:
            rec = load(art, arch, shape, variant=v)
            if rec and rec.get("status") == "ok":
                print(perf_row(v or "baseline(flash)", rec))
        print()


if __name__ == "__main__":
    main()
