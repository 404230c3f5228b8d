"""serve_host_ms: the host's time to enqueue one batch, median over the
untraced window: from the call to ``metric_step`` until it returns, before
the host reads the batch's metrics (the host clock), in ms."""

import statistics


def read(record):
    if record["device"] != "cuda" or not record["window"]["steps"]:
        return None
    return statistics.median(record["window"]["host_s"]) * 1e3
