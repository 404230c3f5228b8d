"""kernel_roofline_pct.train: the least time the train step's counted work needs
(port_bench/counts, the frozen roofline bound summed over the model's
operations) over the step's device busy time in the traced tail (the union
of kernel and copy intervals on the profiler's device timeline over its
steps), in %."""


def read(record):
    trace = record["trace"]
    if record["device"] != "cuda" or not trace or not trace["busy_s"]:
        return None
    return 100.0 * record["work"]["least_s"] / (trace["busy_s"] / trace["steps"])
