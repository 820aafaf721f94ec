"""Share of the traced window in which the card ran no kernel, copy or fill:
one minus the union of their intervals over the window (``trace.py``)."""


def read(out):
    if out.trace is None:
        return None
    return 100.0 * (1.0 - out.trace["busy_s"] / out.trace["window_s"])
