"""Kernel 2.1 (``bpr_persist``): the least time of an epoch's required
work (the configuration's ``bpr_epoch`` count at the card's peaks) over
the kernel's device time an epoch, from the profiler's records of its
launches in the traced epochs, in %."""

KERNEL = r"\bbpr_persist\b"


def read(run):
    launches = run.device(KERNEL)
    if not launches:
        return None
    device_s = sum(e - s for _, s, e in launches) / 1e9
    return 100.0 * run.least("bpr_epoch") * len(launches) / device_s
