"""Kernel launches a training step: every kernel in the traced window over
the traced steps (epochs' ends included)."""


def read(out):
    c = out.counts
    if out.trace is None:
        return None
    return len(out.trace["kernels"]) / c["trace_steps"]
