"""The device's idle time while one of the port's own spans is open.

The port records its phases itself (``cleverrec_tpu_torch.utils.trace``)
while the profiler records: ``card.trace`` keeps only the benchmark's
``portbench.*`` host spans, so the readers take the port's spans from the
port's buffer.  Both are on the profiler's clock, the one its device
records use.  A port without that module gives no spans, and the readers
then return None.
"""

from __future__ import annotations

from portbench import card


def program_records() -> list:
    """The port's closed span records (``name``, ``start_ns``,
    ``end_ns``), or none where the port keeps no spans."""
    try:
        from cleverrec_tpu_torch.utils import trace
    except ImportError:
        return []
    return trace.records()


def overlap_ns(a, b) -> int:
    """Nanoseconds in both of two sorted, disjoint interval lists."""
    total = i = j = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_ms(run, name: str) -> float | None:
    """The device's idle ms a traced unit, counted only while a span
    ``name`` (and so any span below it) is open: the spans' intervals,
    clipped to the traced window, less the union of the device records
    within them.  None where no such span falls in the window."""
    if not run.trace or not run.trace["units"]:
        return None
    lo, hi = run.trace["window"]
    spans = card.clip(card.union((r.start_ns, r.end_ns)
                                 for r in program_records()
                                 if r.name == name), lo, hi)
    if not spans:
        return None
    busy = card.clip(card.union((s, e) for _, s, e in run.trace["device"]),
                     lo, hi)
    idle = sum(e - s for s, e in spans) - overlap_ns(spans, busy)
    return idle / 1e6 / run.trace["units"]
