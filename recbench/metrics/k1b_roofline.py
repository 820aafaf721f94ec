"""K1b's share of its roofline: the Σ of each traced
launch's bound (``kernels.py``: the compact row buffer written once, the
gradient rows and ids read once) over the Σ of K1b's device time (its fill
and its scatter) in the trace.  Nothing where the trace holds another number
of K1b scatters than the one a step the bound counts."""

from recbench import kernels, trace


def _scatter(name):
    return "scatter_add_kernel" in name or "sorted_scatter_kernel" in name


def read(out):
    c = out.counts
    if out.trace is None:
        return None
    seconds = trace.seconds_of(out.trace, kernels.is_k1b)
    if trace.count_of(out.trace, _scatter) != c["trace_steps"] or seconds <= 0:
        return None
    return 100.0 * c["k1b_bound_s"] / seconds
