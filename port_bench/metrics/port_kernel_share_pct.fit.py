"""Share of the traced step's device-busy time spent in the program's own
kernels (the library built from its csrc/, namespace spt::); the rest is
eager PyTorch operations, copies and sets."""

from pb_core.readers import PORT_KERNEL, in_step


def read(run):
    ops = in_step(run)
    if ops is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * sum(d for n, _, d, _ in ops if PORT_KERNEL in n) / run.trace.busy_s
