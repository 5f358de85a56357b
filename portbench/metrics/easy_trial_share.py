"""The EASY step's trial rows in the span campaign's stream, in percent:
the stream time of the ``easy.trial`` spans (each slot's trial allocation
over [B, W + 1, N]) over that of the ``step`` spans
(``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    if ctx["queue"] != "easy_backfill":
        return None
    got = spans.get(ctx)
    if got is None:
        return None
    rec = got["recording"]
    steps = sum(spans.stream_ns(s) for s in spans.named(rec, "step"))
    if steps <= 0:
        return None
    trial = sum(spans.stream_ns(s) for s in spans.named(rec, "easy.trial"))
    return 100.0 * trial / steps
