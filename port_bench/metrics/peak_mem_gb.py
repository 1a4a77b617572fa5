"""torch.cuda.max_memory_allocated() over the window (reset at its start),
in GB (1e9 bytes)."""


def read(run):
    peak = getattr(run, "window_peak_bytes", None)
    return None if not peak else peak / 1e9
