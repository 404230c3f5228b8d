"""peak_mem_gib.train: the caching allocator's peak over the measured window
(``torch.cuda.max_memory_allocated()`` after ``reset_peak_memory_stats()``
at the window's start), in GiB: what decides the largest batch that fits."""


def read(record):
    if record["device"] != "cuda":
        return None
    return record["peak_window_bytes"] / 2 ** 30
