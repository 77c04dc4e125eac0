"""plain_ops_share: the share of the card's busy time spent in operations
that the port's own CUDA library did not launch, in %: PyTorch's kernels
(elementwise, reductions, copies, fills), cuBLAS and the runtime's copies
and fills, named below by the marks in their profiler names."""

from devtrace import busy_us

# Marks of the device operations that are not the port's kernels.  The
# port's kernels are its own C++ functions and carry none of these.
PLAIN = ("at::", "at_cuda_detail", "cub::", "cublas", "gemv", "gemm",
         "cutlass", "Memcpy", "Memset", "memcpy", "memset")


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    busy = t.busy_s
    plain = busy_us([(s, e) for n, s, e in t.device
                     if any(m in n for m in PLAIN)]) * 1e-6
    return 100.0 * plain / busy if busy > 0 else None
