"""kth_free kernel launches (the wrapper's host-side counter) over the
window's steps; nothing on the CPU, where the plain twin runs."""


def read(ctx):
    if ctx["kth_launches"] == 0:
        return None
    return ctx["kth_launches"] / ctx["window_steps"]
