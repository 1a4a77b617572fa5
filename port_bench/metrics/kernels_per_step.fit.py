"""Device kernels launched in the traced fit step, all of them (the
profiler's count of kernel events; copies and sets not counted)."""

from pb_core.readers import STEP_MARK


def read(run):
    t = run.trace
    if t is None or STEP_MARK not in t.marks:
        return None
    return float(t.count("kernel", *t.marks[STEP_MARK]))
