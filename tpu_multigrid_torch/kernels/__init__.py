"""Hand-written CUDA kernels for Hopper and their wrappers.

Each wrapper runs its kernel's plain torch version on CPU tensors and
launches the kernel on CUDA tensors.  Nothing is built when this package is
imported: ``_build.lib()`` compiles ``csrc/*.cu`` at the first launch.
"""

from . import (compres, fas, fas3d, lines, local, localfas, localref,
               stencil, stencil3d, transfer, transfer3d, varstencil,
               vartransfer, vartransfer3d)

_MODULES = (transfer, stencil, compres, varstencil, vartransfer, stencil3d,
            transfer3d, vartransfer3d, lines, fas, fas3d, local, localref,
            localfas)


def launch_counts() -> dict:
    """Kernel launches per wrapper entry since the last reset."""
    return {name: count for m in _MODULES for name, count in m.LAUNCHES.items()}


def reset_launch_counts() -> None:
    for m in _MODULES:
        for name in m.LAUNCHES:
            m.LAUNCHES[name] = 0
