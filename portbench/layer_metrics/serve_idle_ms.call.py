"""The device's idle ms a call while the port's ``serve.call`` span (the
live ``retrieve`` of ``build_retrieval_fn``, the ids' copy to the device
included) is open on the host."""

from portbench import spans


def read(run):
    return spans.idle_ms(run, "serve.call")
