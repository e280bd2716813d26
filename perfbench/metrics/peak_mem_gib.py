"""peak_mem_gib: device memory allocated at the peak of the window
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats`` at
its start), GiB."""


def read(run):
    if run.peak_window_bytes is None:
        return None
    return run.peak_window_bytes / 2**30
