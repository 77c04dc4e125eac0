"""peak_mem_gib: the program's peak on the card over the window, in GiB:
``torch.cuda.max_memory_allocated`` after a reset at the window's start,
less the bytes the harness holds there all through the window (the pool of
right-hand sides and the check's sample buffers, the same on every
commit).  The result line's ``memory_peak_bytes`` keeps the whole peak."""


def read(run):
    return (run.peak_bytes - run.held_bytes) / 2 ** 30 if run.peak_bytes \
        else None
