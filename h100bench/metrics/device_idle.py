"""device_idle: the share of the traced window in which nothing ran on the
card, in %: 100 (1 - busy / window), busy the union of the device's
operation intervals (``devtrace.busy_us``, from ``profile_vcycle.py``)."""


def read(run):
    t = run.trace
    if t is None or not t.device or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
