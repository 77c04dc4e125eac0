"""solve_ms_p95: the 95th percentile of every solve's time in the window, in
milliseconds, each timed from the call until it returns and the card is
done.  Needs 200 solves or more, so that ten lie beyond it."""

import statistics


def read(run):
    if len(run.solve_s) < 200:
        return None
    return statistics.quantiles(run.solve_s, n=20)[18] * 1e3
