"""The device's idle ms an epoch while the port's ``train.sample`` span
(inside ``Trainer.sample_epoch``) is open on the host."""

from portbench import spans


def read(run):
    return spans.idle_ms(run, "train.sample")
