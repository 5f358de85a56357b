"""The device memory peak over the window (``max_memory_allocated``
after a reset at the window's start), GiB: the widest campaign a card
holds, and where work moves into memory."""


def read(ctx):
    peak = ctx["peak_bytes"]
    return None if peak is None else peak / 2 ** 30
