"""The device's idle ms an evaluation while the port's ``eval.metrics``
span (``Evaluator._metric_sums`` on a batch) is open on the host."""

from portbench import spans


def read(run):
    return spans.idle_ms(run, "eval.metrics")
