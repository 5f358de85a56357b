"""Device operations (kernels, memsets, copies) of the traced campaign
over its steps: the host dispatch each step pays."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.ops:
        return None
    return len(tr.ops) / ctx["trace_steps"]
