"""mfu.serve: the serve step's counted FLOPs (port_bench/counts) over the step
time of the untraced window (its length over its steps) times the peak of
the precision the products run in, in %.  Moves the cell's throughput."""


def read(record):
    if record["device"] != "cuda" or not record["window"]["steps"]:
        return None
    step_s = record["window"]["window_s"] / record["window"]["steps"]
    return 100.0 * record["work"]["flops"] / (step_s * record["work"]["peak"])
