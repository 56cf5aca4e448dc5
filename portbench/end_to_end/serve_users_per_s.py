"""Users answered per second: every user of every completed call, over
the window."""


def read(run):
    if run.kind != "serve":
        return None
    return sum(u["work"]["users"] for u in run.units) / run.window_s
