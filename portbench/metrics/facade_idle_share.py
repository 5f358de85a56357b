"""Device idle time that the facade leaves, in percent of the campaign's
host wall: the span campaign's idle gaps between device operations that
begin while the host's innermost open span is a facade span (``run`` or
``run.*``: outside every step), over the ``run`` span's host wall
(``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    got = spans.get(ctx)
    if got is None:
        return None
    run = spans.named(got["recording"], "run")
    if len(run) != 1:
        return None
    idle = sum(sec for sec, s in spans.gaps_by_span(got)
               if s is not None and spans.is_facade(s.name))
    return 100.0 * idle * 1e9 / (run[0].end_ns - run[0].start_ns)
