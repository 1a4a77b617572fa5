"""Share of the traced fit step's device time spent turning (pixel, sample)
ids into camera rays: 100 x the device milliseconds of the step's
``spt.rays.camera`` spans over those of its ``spt.fit.step`` span.  It
reads the program's own spans (``tracing.spans()`` of the package the run
imported; CUDA-event times), not the profiler's trace; None in an untraced
run, or where the program has no such spans."""

from pb_core import program


def read(run):
    if getattr(run, "trace", None) is None:
        return None
    tracing = getattr(program.load(), "tracing", None)
    if tracing is None:
        return None
    recs = tracing.spans()
    steps = {r["id"]: r["device_ms"] for r in recs
             if r["name"] == "spt.fit.step" and r["device_ms"] is not None}
    rays = [r["device_ms"] for r in recs
            if r["name"] == "spt.rays.camera" and r["request"] in steps]
    step_ms = sum(steps.values())
    if not rays or step_ms <= 0:
        return None
    return 100.0 * sum(rays) / step_ms
