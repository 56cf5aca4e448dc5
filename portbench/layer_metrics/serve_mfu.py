"""A whole call's share of the card's peak where calls queue back to back:
the least time of its required work (the configuration's ``serve_call``
count) over its service time (issue to ids on the host), averaged over
the window's calls, in %."""


def read(run):
    if run.kind != "serve" or not run.units:
        return None
    return 100.0 * run.least("serve_call") * len(run.units) / sum(
        u["work"]["service_s"] for u in run.units)
