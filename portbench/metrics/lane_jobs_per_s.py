"""Jobs x lanes of every campaign of the window over the window's wall
seconds (host clock, the device synchronised at the window's end)."""


def read(ctx):
    return ctx["lane_jobs"] / ctx["wall_s"]
