"""The traced campaign's wall time in which no device operation ran, in
percent (1 - union of device intervals / that campaign's own wall)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.ops:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.wall_s)
