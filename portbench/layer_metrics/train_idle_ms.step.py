"""The device's idle ms an epoch while one of the port's ``train.step``
spans (an optimizer step of ``Trainer._steps``, the scan tiers') is open
on the host."""

from portbench import spans


def read(run):
    return spans.idle_ms(run, "train.step")
