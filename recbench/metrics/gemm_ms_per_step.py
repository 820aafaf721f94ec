"""Device milliseconds a training step in the GEMM kernels (cuBLAS and
CUTLASS names holding ``gemm`` or ``gemv``, the interaction's batched
product among them), over the traced steps."""

from recbench import trace


def _gemm(name):
    low = name.lower()
    return "gemm" in low or "gemv" in low


def read(out):
    c = out.counts
    if out.trace is None:
        return None
    return 1e3 * trace.seconds_of(out.trace, _gemm) / c["trace_steps"]
