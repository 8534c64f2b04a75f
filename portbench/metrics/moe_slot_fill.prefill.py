"""moe_slot_fill.prefill: the share of the expert buffers' slots that
held an assignment over the traced batches, in %, from the program's
slot counter (``spans.RECORDS["moe.slots"]``, filled by
`models.moe._dispatch_plan`; `program.slot_fill`).  The rest of the
expert products run on zero rows."""
from portbench import program


def read(run):
    return program.slot_fill()
