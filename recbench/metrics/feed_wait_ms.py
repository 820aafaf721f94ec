"""The host's wait for the next batch: the mean ``avg_reader_cost`` of the
trainer's own log lines in the untraced window, in milliseconds."""


def read(out):
    c = out.counts
    if not c["reader_cost_s"]:
        return None
    return 1e3 * sum(c["reader_cost_s"]) / len(c["reader_cost_s"])
