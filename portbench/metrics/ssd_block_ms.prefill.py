"""ssd_block_ms.prefill: device ms a batch of the operations launched
inside the program's ``ssd_block`` spans (`models.ssm.ssd_block`, the
Mamba2 mixer: the in-projections, the causal convolutions, the scan, the
gate, the gated norm and the out-projection), every layer's."""


def read(run):
    ops = run.trace.under("ssd_block")
    return run.per_step(ops) * 1e3 if ops else None
