"""attention_ms.prefill: device ms a batch of the operations launched
inside the program's ``attention_block`` spans (`models.attention`: the
q/k/v projections, rope and qk-norm, flash, the cache fill and the
output projection), every layer's."""


def read(run):
    ops = run.trace.under("attention_block")
    return run.per_step(ops) * 1e3 if ops else None
