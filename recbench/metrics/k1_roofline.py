"""K1's share of its roofline: the Σ of each traced
launch's bound (``kernels.py``, from its batch's own ids) over the Σ of
K1's device time in the trace.  Nothing where the trace holds another
number of K1 launches than the one a step the bound counts."""

from recbench import kernels, trace


def read(out):
    c = out.counts
    if out.trace is None:
        return None
    seconds = trace.seconds_of(out.trace, kernels.is_k1)
    if trace.count_of(out.trace, kernels.is_k1) != c["trace_steps"] or seconds <= 0:
        return None
    return 100.0 * c["k1_bound_s"] / seconds
