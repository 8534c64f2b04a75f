"""shared_block_ms.prefill: device ms a batch of the operations launched
inside the program's ``shared_block`` spans (`models.model.shared_block`:
the concatenation with the embedding's output, the block's two norms, its
attention (`attention_block`, flash and the shared K/V cache fill), its
MLP with the application's adapter, and the layer's own linear), every
application's."""


def read(run):
    ops = run.trace.under("shared_block")
    return run.per_step(ops) * 1e3 if ops else None
