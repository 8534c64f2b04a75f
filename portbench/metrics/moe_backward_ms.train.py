"""moe_backward_ms.train: device ms a step of the operations launched
inside the program's ``moe.backward`` spans (`models.moe._Dispatch` and
`_Combine`: the backwards of the two reads through the slot map, each a
gather of the gradient through the map's inverse)."""


def read(run):
    ops = run.trace.under("moe.backward")
    return run.per_step(ops) * 1e3 if ops else None
