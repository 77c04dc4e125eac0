"""solve_ms: the whole measured window over the solves completed in it, in
milliseconds (one closed-loop caller; the window ends at a completion)."""


def read(run):
    return run.window_s / len(run.solve_s) * 1e3
