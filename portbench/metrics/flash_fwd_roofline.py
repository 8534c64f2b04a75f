"""flash_fwd_roofline: the flash forward's share of its roofline, the
least time its causal shape allows (`counts.flops.roofline_ms` of
`flash_flops` and `flash_bytes`) over the mean device time of the
``flash_fwd_*`` kernels in the trace.  Read where every attention of the
model has one shape (heads, kv heads, head size)."""
from portbench.counts import flops


def read(run):
    ks = [op.dur_s for op in run.trace.ops if "flash_fwd_" in op.name.lower()]
    m, t = run.m, run.traffic
    shapes = set()
    for g in m["groups"]:
        for ls in g["layers"]:
            if ls["mixer"] == "attn":
                shapes.add((m["num_heads"], m["num_kv_heads"]))
            if ls.get("shared_attn"):
                shapes.add((m["shared_attn_heads"], m["shared_attn_kv_heads"]))
    if not ks or len(shapes) != 1:
        return None
    (Hq, Hkv), = shapes
    B, S, D = t["batch"], t["seq"], m["head_dim"]
    bound = flops.roofline_ms(flops.flash_flops(B, S, S, Hq, D, True),
                              flops.flash_bytes(B, S, Hq, Hkv, D))
    return 100.0 * bound / (sum(ks) / len(ks) * 1e3)
