"""Test users ranked over the whole catalog per second: the test users
times the evaluations completed, over the window."""


def read(run):
    if run.kind != "eval":
        return None
    return run.shape["test_users"] * len(run.units) / run.window_s
