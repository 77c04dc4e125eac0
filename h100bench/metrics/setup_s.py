"""setup_s: seconds from the start of the process to the first timed
request: imports, loading (in a first run, building) the kernel library,
the hierarchy, the pool of right-hand sides and one warm-up solve."""


def read(run):
    return run.setup_s
