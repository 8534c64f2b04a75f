"""moe_combine_ms.prefill: device ms a batch of the operations launched
inside the program's ``moe.combine`` spans (`models.moe._combine`: the
padded ``cat``, the gather of each token's k outputs, the gate weights
and the sum over k)."""


def read(run):
    ops = run.trace.under("moe.combine")
    return run.per_step(ops) * 1e3 if ops else None
