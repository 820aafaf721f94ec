"""The model FLOPs a training step needs (``models/<model>.py`` ``flops``,
from the configuration's widths) over the untraced window's wall time, as a
share of the card's float32 peak (``peaks.py``)."""


def read(out):
    c = out.counts
    if c["driver"] != "train" or c["window_s"] <= 0:
        return None
    return 100.0 * c["flops"] / c["window_s"] / c["peak_flops"]
