"""peak_mem_gb (GB): torch.cuda.max_memory_allocated() over the window,
after reset_peak_memory_stats(); what decides which families fit."""


def read(run):
    return None if run.peak_bytes is None else run.peak_bytes / 1e9
