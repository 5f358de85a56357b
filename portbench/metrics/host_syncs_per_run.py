"""Host synchronisations of one campaign (``Scheduler.run`` over the
stream's first trace_jobs jobs at the cell's lanes), by PyTorch's sync
debug mode: the facade's prologue and epilogue, since the step loop makes
none."""


def read(ctx):
    return ctx["syncs"]
