"""moe_route_ms.prefill: device ms a batch of the operations launched
inside the program's ``moe.route`` spans (`models.moe.moe_block`: the
router's f64 product, softmax, top-k and the aux loss's statistics)."""


def read(run):
    ops = run.trace.under("moe.route")
    return run.per_step(ops) * 1e3 if ops else None
