"""Jobs placed out of arrival order over all jobs placed in the window
(n_backfilled summed over every lane of every campaign / jobs x lanes), in
percent: the useful outcomes of the W + 1 slots an EASY step scores."""


def read(ctx):
    if ctx["queue"] != "easy_backfill":
        return None
    return 100.0 * ctx["n_backfilled"] / ctx["lane_jobs"]
