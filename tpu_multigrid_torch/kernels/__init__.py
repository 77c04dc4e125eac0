"""Hand-written CUDA kernels for Hopper and their wrappers.

Each wrapper runs its kernel's plain torch version on CPU tensors and
launches the kernel on CUDA tensors.  Nothing is built when this package is
imported: ``_build.lib()`` compiles ``csrc/*.cu`` at the first launch.
"""

from . import compres, transfer


def launch_counts() -> dict:
    """Kernel launches per wrapper entry since the last reset."""
    return {**transfer.LAUNCHES, **compres.LAUNCHES}


def reset_launch_counts() -> None:
    for counts in (transfer.LAUNCHES, compres.LAUNCHES):
        for name in counts:
            counts[name] = 0
