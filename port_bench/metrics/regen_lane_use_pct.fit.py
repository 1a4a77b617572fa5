"""Share of the thread slots of the traced fit step's idx-only regen
forward launches (``regen_idx_kernel``: a resident grid whose threads fetch
lanes from a work queue) that ran a live lane iteration: 100 x the lanes'
live iterations over the kernel's thread-iterations (32 per loop trip of a
warp), summed over the step's ``spt.regen.forward`` spans.  It reads the
program's own spans (``tracing.spans()`` of the package the run imported:
the summed lane counts and each launch's work queue); None in an untraced
run, or where no span holds thread-iterations (the plain versions have no
thread slots)."""

from pb_core import program


def read(run):
    if getattr(run, "trace", None) is None:
        return None
    tracing = getattr(program.load(), "tracing", None)
    if tracing is None:
        return None
    recs = tracing.spans()
    steps = {r["id"] for r in recs if r["name"] == "spt.fit.step"}
    fwd = [r["counts"] for r in recs if r["name"] == "spt.regen.forward"
           and r["request"] in steps and r["counts"].get("thread_iters")]
    threads = sum(c["thread_iters"] for c in fwd)
    if threads <= 0:
        return None
    return 100.0 * sum(c.get("live_iters", 0) for c in fwd) / threads
