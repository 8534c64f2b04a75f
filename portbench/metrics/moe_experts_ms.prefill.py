"""moe_experts_ms.prefill: device ms a batch of the operations launched
inside the program's ``moe.experts`` spans (`models.moe._expert_mlp`:
the three batched expert products and the SwiGLU)."""


def read(run):
    ops = run.trace.under("moe.experts")
    return run.per_step(ops) * 1e3 if ops else None
