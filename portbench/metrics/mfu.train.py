"""mfu.train: the train step's model FLOP (the configuration's reference
module's ``model_flops``: 6 N T plus three times the causal attention,
no recompute counted) over the unprofiled seconds a step took in the
window times the bf16 peak."""
from portbench.counts import flops


def read(run):
    t = run.traffic
    f = run.ref.model_flops(run.m, t["batch"], t["seq"], "train")
    return 100.0 * f / (run.step_s * flops.PEAK_BF16_FLOPS)
