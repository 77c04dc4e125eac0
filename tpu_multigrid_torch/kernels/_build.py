"""Build the CUDA kernels under ``csrc/`` and bind them with ctypes.

At first use every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``), one compiler per source, all in parallel, and linked into one
shared library with a plain C interface, under
``build/kernels-<hash>/`` at the root of the checkout, keyed by a hash of
the sources and flags so that an edited source builds anew.  The library is
loaded with ``ctypes``; every C entry launches on the stream it is given and
returns ``cudaGetLastError()``.  A failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build"

# -fmad=false: no multiply-add contraction anywhere, so the kernels round
# exactly as their plain torch versions do.  No fast-math.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "tmt_transfer_tile": ([], _I),
    "tmt_transfer_max_steps": ([], _I),
    "tmt_stencil_max_steps": ([], _I),
    "tmt_error_string": ([_I], ctypes.c_char_p),
    # u, b, u_out, rc, S, Sc, n, steps, rbgs, weights, count, stream
    "tmt_smooth_restrict": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _P],
                            _I),
    # u, b, ec, u_out, partials, out_sum, S, Sc, n, steps, rbgs, weights,
    # count, stream
    "tmt_prolong_smooth": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                            _I, _P], _I),
    # r, rc, S, Sc, n, stream
    "tmt_restrict_fw": ([_P, _P, _I, _I, _I, _P], _I),
    # u, ec, out, S, Sc, n, stream
    "tmt_prolong_add": ([_P, _P, _P, _I, _I, _I, _P], _I),
    # ec, hi, err, S, Sc, n, stream
    "tmt_prolong_comp": ([_P, _P, _P, _I, _I, _I, _P], _I),
    # u, b, u_out, r_out, S, n, steps, first_step, rbgs, weights, count,
    # stream
    "tmt_streamed": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _P], _I),
    # b, u_hi, u_lo, r, S, n, stream
    "tmt_ds_residual": ([_P, _P, _P, _P, _I, _I, _P], _I),
    # b, u_hi, u_mid, u_lo, r, S, n, stream
    "tmt_ts_residual": ([_P, _P, _P, _P, _P, _I, _I, _P], _I),
    "tmt_var_tile": ([], _I),
    "tmt_var_max_halo": ([_I], _I),
    # u, b, coef, u_out, r_out, S, n, steps, rbgs, nplanes, weights, count,
    # stream
    "tmt_var_streamed": ([_P] * 5 + [_I] * 5 + [_P, _I, _P], _I),
    # u, b, coef, u_out, rc, S, Sc, n, steps, rbgs, nplanes, weights, count,
    # stream
    "tmt_var_smooth_restrict": ([_P] * 5 + [_I] * 6 + [_P, _I, _P], _I),
    # u, b, ec, coef, u_out, partials, out_sum, S, Sc, n, steps, rbgs,
    # nplanes, weights, count, stream
    "tmt_var_prolong_smooth": ([_P] * 7 + [_I] * 6 + [_P, _I, _P], _I),
    "tmt_stencil3d_max_steps": ([], _I),
    "tmt_window3_max_halo": ([], _I),
    # u, b, u_out, r_out, Sz, Sy, Sx, n, steps, first_step, rbgs, weights,
    # count, stream
    "tmt_streamed3": ([_P] * 4 + [_I] * 7 + [_P, _I, _P], _I),
    # u, b, u_out, rc, Sz, Sy, Sx, Szc, Syc, Scx, n, steps, first_step,
    # rbgs, weights, count, taps, ntaps, stream
    "tmt_smooth_restrict3": ([_P] * 4 + [_I] * 10 + [_P, _I, _P, _I, _P],
                             _I),
    # Sz, Sy, Sx, steps
    "tmt_prolong_smooth3_blocks": ([_I] * 4, _I),
    # u, b, ec, u_out, partials, out_sum, Sz, Sy, Sx, Szc, Syc, Scx, n,
    # steps, first_step, rbgs, weights, count, taps, ntaps, stream
    "tmt_prolong_smooth3": ([_P] * 6 + [_I] * 10 + [_P, _I, _P, _I, _P],
                            _I),
    # u, b, coef, u_out, rc, Sz, Sy, Sx, Szc, Syc, Scx, n, steps,
    # first_step, rbgs, nplanes, weights, count, stream
    "tmt_var_smooth_restrict3": ([_P] * 5 + [_I] * 11 + [_P, _I, _P], _I),
    # u, b, ec, coef, u_out, partials, out_sum, Sz, Sy, Sx, Szc, Syc, Scx,
    # n, steps, first_step, rbgs, nplanes, weights, count, stream
    "tmt_var_prolong_smooth3": ([_P] * 7 + [_I] * 11 + [_P, _I, _P], _I),
}

_lock = threading.Lock()
_lib = None


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_ROOT / f"kernels-{h.hexdigest()[:16]}"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("cannot build the CUDA kernels: no CUDA toolkit "
                           "found (set CUDA_HOME or put nvcc on PATH)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _run_all(cmds, log) -> None:
    """Run the commands side by side; append each one's output to ``log``
    and raise on the first that failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    failed = None
    for cmd, proc in zip(cmds, procs):
        out, err = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out + err)
        if proc.returncode != 0 and failed is None:
            failed = (f"nvcc failed with exit code {proc.returncode}:\n"
                      f"{err[-4000:]}")
    if failed is not None:
        raise RuntimeError(failed)


def build() -> Path:
    """Compile the sources unless this hash is built already; returns the
    library's path.  Each ``.cu`` compiles in an ``nvcc`` of its own, all
    started together, and one more links them.  The compiler's output
    (``-Xptxas=-v``: registers and shared memory per kernel) is kept in
    ``build.log`` beside the library."""
    out_dir = build_dir()
    lib_path = out_dir / "libtmt_kernels.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    srcs = [p for p in sources() if p.suffix == ".cu"]
    objs = [out_dir / f"{p.stem}.{tag}.o" for p in srcs]
    tmp = out_dir / f"libtmt_kernels.{tag}.so"
    log = []
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)]
                  for p, o in zip(srcs, objs)], log)
        _run_all([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                   *map(str, objs)]], log)
    finally:
        (out_dir / "build.log").write_text("".join(log))
        for o in objs:
            o.unlink(missing_ok=True)
    os.replace(tmp, lib_path)   # atomic: concurrent builders never see half
    return lib_path


def lib() -> ctypes.CDLL:
    """The bound kernel library, built at first use.  Its constants are read
    once, at binding: ``transfer_tile`` (K1/K2's fine tile edge),
    ``transfer_max_steps`` (the most steps whose K1 window fits in shared
    memory), ``stencil_max_steps`` (the most steps of one streaming-
    smoother launch), ``var_tile`` (the var kernels' tile edge) and
    ``var_max_halo`` (nplanes -> the deepest halo of a var kernel's
    window)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = restype
            handle.transfer_tile = handle.tmt_transfer_tile()
            handle.transfer_max_steps = handle.tmt_transfer_max_steps()
            handle.stencil_max_steps = handle.tmt_stencil_max_steps()
            handle.var_tile = handle.tmt_var_tile()
            handle.var_max_halo = {p: handle.tmt_var_max_halo(p)
                                   for p in (5, 9)}
            handle.stencil3d_max_steps = handle.tmt_stencil3d_max_steps()
            handle.window3_max_halo = handle.tmt_window3_max_halo()
            _lib = handle
    return _lib


def check_inputs(entry: str, tensors, shapes) -> None:
    """Validate what a C entry takes: contiguous float32 CUDA tensors of the
    given shapes, all on one device."""
    device = tensors[0].device
    for t, shape in zip(tensors, shapes):
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"{entry}: expected CUDA tensors on one device, "
                             f"got {t.device} beside {device}")
        if t.dtype != torch.float32:
            raise NotImplementedError(
                f"{entry}: the kernel takes float32 only, got {t.dtype}")
        if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(f"{entry}: expected a contiguous {tuple(shape)} "
                             f"tensor, got {tuple(t.shape)}")


def check(err: int, entry: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if err != 0:
        msg = lib().tmt_error_string(err).decode()
        raise RuntimeError(f"{entry}: CUDA error {err} ({msg})")
