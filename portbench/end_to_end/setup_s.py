"""Set-up: process start to the first timed unit (data, the port's
objects, the weights, the kernels' builds, warm-up), host clock."""


def read(run):
    return run.setup_s
