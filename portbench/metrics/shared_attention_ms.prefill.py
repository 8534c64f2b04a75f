"""shared_attention_ms.prefill: device ms a batch of the operations
launched inside the program's ``attention_block`` spans where the model's
attention is the Zamba2 shared blocks' (`models.attention`: the q/k/v
projections from the 7,168-wide concatenation, rope, flash at head_dim
224, the shared K/V cache fill and the output projection), every
application's.  The same span as ``attention_ms.prefill``, whose cells
are the models with attention mixers."""


def read(run):
    ops = run.trace.under("attention_block")
    return run.per_step(ops) * 1e3 if ops else None
