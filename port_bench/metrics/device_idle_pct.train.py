"""device_idle_pct.train: 1 - (union of kernel and copy intervals on the
profiler's device timeline) / (the traced window), in %, over the traced
tail's train steps."""


def read(record):
    trace = record["trace"]
    if record["device"] != "cuda" or not trace or not trace["window_s"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
