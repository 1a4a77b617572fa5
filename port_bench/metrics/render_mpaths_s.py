"""Millions of paths (width x height x spp of every frame completed) per
second of the window, on the host clock."""


def read(run):
    if getattr(run, "paths", None) is None or not run.window_s:
        return None
    return run.paths / run.window_s / 1e6
