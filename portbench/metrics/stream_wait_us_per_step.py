"""How long a step's work waits in the stream before the device reaches
it: the median over the span campaign's ``step`` spans of the stream's
entry time less the host's (``portbench/spans.py``), microseconds.  Large:
the device sets the pace and the host fills the launch queue ahead of it;
near 0: the host does."""

import statistics

from portbench import spans


def read(ctx):
    got = spans.get(ctx)
    if got is None:
        return None
    waits = [s.dev_start_ns - s.start_ns
             for s in spans.named(got["recording"], "step")]
    return statistics.median(waits) / 1e3 if waits else None
