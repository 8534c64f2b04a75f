"""moe_block_ms.prefill: device ms a batch of the operations launched
inside the benchmark's span around `models.moe.moe_block` (router,
dispatch, expert products, combine)."""
SPANS = [("repro_torch.models.moe", "moe_block", "portbench.moe_block")]


def read(run):
    ops = run.trace.under("portbench.moe_block")
    return run.per_step(ops) * 1e3 if ops else None
