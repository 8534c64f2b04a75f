"""moe_dispatch_ms.prefill: device ms a batch of the operations launched
inside the program's ``moe.dispatch`` spans (`models.moe._dispatch_plan`
and `_dispatch_buffer`: the sort by expert, the counts, the slot map's
``index_copy_``, the padded ``cat`` and the gather into the (E,
capacity, d) buffer)."""


def read(run):
    ops = run.trace.under("moe.dispatch")
    return run.per_step(ops) * 1e3 if ops else None
