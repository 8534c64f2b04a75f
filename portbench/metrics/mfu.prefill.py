"""mfu.prefill: the prefill's model FLOP a batch (the configuration's
reference module's ``model_flops``) over the unprofiled seconds a batch
took in the window times the bf16 peak."""
from portbench.counts import flops


def read(run):
    t = run.traffic
    f = run.ref.model_flops(run.m, t["batch"], t["seq"], "prefill")
    return 100.0 * f / (run.step_s * flops.PEAK_BF16_FLOPS)
