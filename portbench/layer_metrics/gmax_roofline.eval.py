"""Kernel 2.3 (``dot_gmax``'s ``dot_tile_kernel`` or ``dot_strip_kernel``)
over an evaluation: the least time of its launches' required work (the
configuration's ``gmax_eval`` count at the card's peaks) over their
device time, from the profiler's records in the traced evaluations, in %."""

KERNEL = r"\bdot_(tile|strip)_kernel\b"


def read(run):
    launches = run.device(KERNEL)
    if not launches:
        return None
    device_s = sum(e - s for _, s, e in launches) / 1e9
    return 100.0 * run.least("gmax_eval") * run.trace["units"] / device_s
