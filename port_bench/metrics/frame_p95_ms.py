"""95th percentile of the times of all frames of the window, each from the
call until torch.cuda.synchronize() returns."""

from pb_core.clock import percentile


def read(run):
    frames = getattr(run, "frames", None)
    if not frames:
        return None
    return 1e3 * percentile(frames, 95.0)
