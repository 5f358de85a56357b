"""The facade's prologue in the span campaign's stream, in percent: the
stream time of ``run.workload_arrays``, ``run.setup`` and
``run.job_draws`` over that of ``run`` (``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    got = spans.get(ctx)
    if got is None:
        return None
    rec = got["recording"]
    run = spans.named(rec, "run")
    if len(run) != 1:
        return None
    pro = sum(spans.stream_ns(s) for s in rec.spans
              if s.name in spans.PROLOGUE)
    return 100.0 * pro / spans.stream_ns(run[0])
