"""Microseconds a step in which some device operation ran (the union of
the traced campaign's device intervals over its steps)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.ops:
        return None
    return tr.busy_s() * 1e6 / ctx["trace_steps"]
