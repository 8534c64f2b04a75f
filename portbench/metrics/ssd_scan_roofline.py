"""ssd_scan_roofline: the SSD scan kernel's share of its roofline, the
least time its shape allows (`counts.flops.roofline_ms` of `ssd_ops` and
`ssd_bytes`, x, B and C in bfloat16) over the mean device time of the
``ssd_scan_*`` kernels in the trace.  Read where every SSD layer of the
model has one shape, the cell's batch and sequence."""
from portbench.counts import flops


def read(run):
    ks = [op.dur_s for op in run.trace.ops if "ssd_scan_" in op.name.lower()]
    m, t = run.m, run.traffic
    if not ks:
        return None
    P, N, G = m["ssm_head_dim"], m["ssm_state"], m["ssm_ngroups"]
    H = m["ssm_expand"] * m["d_model"] // P
    B, S = t["batch"], t["seq"]
    bound = flops.roofline_ms(flops.ssd_ops(B, S, H, P, N, m["ssd_chunk"]),
                              flops.ssd_bytes(B, S, H, P, G, N))
    return 100.0 * bound / (sum(ks) / len(ks) * 1e3)
