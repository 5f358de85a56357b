"""The kth_free kernel's share of its memory roofline over the traced
campaign, in percent: the call's logical bytes at the HBM rate
(``portbench/roofline.py``: each input byte once, each output once, a
shared table once a call) over the device time of the kernels named
below."""

from portbench import roofline

#: the CUDA kernels of ``kernels/kth_free/csrc/kth_free.cu``
KERNELS = ("kth_free_rank", "kth_free_smem")


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    seconds = sum(tr.seconds_by_name(KERNELS).values())
    if seconds <= 0:
        return None
    nbytes = ctx["trace_steps"] * roofline.kth_free_step_bytes(
        ctx["queue"], ctx["lanes"], ctx["systems"], ctx["nodes"],
        ctx["window"])
    return 100.0 * roofline.least_seconds(nbytes) / seconds
