"""The model FLOPs of the forward passes scored (``models/<model>.py``
``flops``) over the untraced window's wall time, as a share of the card's
float32 peak (``peaks.py``)."""


def read(out):
    c = out.counts
    if c["driver"] != "score" or c["window_s"] <= 0:
        return None
    return 100.0 * c["flops"] / c["window_s"] / c["peak_flops"]
