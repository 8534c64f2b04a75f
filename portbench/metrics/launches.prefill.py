"""launches.prefill: CUDA kernels a batch in the trace (copies and sets
not counted): the host's dispatch work in `models.model.run_groups`."""


def read(run):
    if run.trace is None:
        return None
    n = sum(op.is_kernel for op in run.trace.ops)
    return n / run.steps_traced if n else None
