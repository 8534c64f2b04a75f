"""What the program itself recorded while the traced calls ran: the host
totals of its spans and its MoE slot counter (`repro_torch.spans`: its
``SECONDS`` and ``COUNTS``, and ``RECORDS["moe.slots"]``, which
`models.moe` fills), all kept only while a profiler records.  They hold
every profiled call since the process started or since `spans.clear`: in
a benchmark run, one process, the one traced pass.  Each reader returns
None where the program has no such span or counter (a program older than
them)."""
from __future__ import annotations

from typing import Optional


def span_host_ms(name: str) -> Optional[float]:
    """Host ms a call inside the program's span ``name``: its host
    seconds over its count."""
    try:
        from repro_torch.spans import COUNTS, SECONDS
    except ImportError:
        return None
    n = COUNTS.get(name, 0)
    return 1e3 * SECONDS[name] / n if n else None


def slot_fill() -> Optional[float]:
    """The share of the MoE buffers' expert slots that held an
    assignment, in %: kept = sum_e min(count_e, capacity) over slots =
    E x capacity, summed over every dispatch plan recorded."""
    try:
        from repro_torch.spans import RECORDS
    except ImportError:
        return None
    plans = RECORDS.get("moe.slots")
    if not plans:
        return None
    kept = sum(counts.clamp(max=cap).sum() for counts, cap in plans)
    slots = sum(counts.numel() * cap for counts, cap in plans)
    return 100.0 * float(kept) / slots
