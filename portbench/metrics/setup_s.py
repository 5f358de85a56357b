"""Process start to the window's start: the CUDA context, the stream
built on the host through the port's front end, the kth_free library
(compiled where the checkout has none) and one warm campaign of a few
steps at the cell's lanes."""


def read(ctx):
    return ctx["setup_s"]
