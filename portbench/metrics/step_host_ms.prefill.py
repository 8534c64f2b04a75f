"""step_host_ms.prefill: host ms a batch inside the program's
``serve.prefill`` span (`training.train_state`'s one-device prefill
step), the span's host seconds over its count (`program.span_host_ms`),
under the profiler.  This is not the host's launch cost: once the card's
command queue is full the host blocks on it, so the reading follows the
batch's device time, and a change that only speeds the card lowers it as
much as one that cuts launches.  What it tells: at or below the batch's
device time the host keeps ahead of the card; above it, the host holds
the card back."""
from portbench import program


def read(run):
    return program.span_host_ms("serve.prefill")
