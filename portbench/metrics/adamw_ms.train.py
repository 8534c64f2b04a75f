"""adamw_ms.train: device ms a step of the operations launched inside the
program's own ``adamw_update`` range (`training.train_state`), AdamW's
per-leaf update of the float32 masters and moments."""


def read(run):
    ops = run.trace.under("adamw_update")
    return run.per_step(ops) * 1e3 if ops else None
