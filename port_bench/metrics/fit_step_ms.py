"""The window's length over the fit steps completed in it (a step: the
loss, its backward, the Adam update and loss.item())."""


def read(run):
    steps = getattr(run, "steps", None)
    if not steps or not run.window_s:
        return None
    return 1e3 * run.window_s / len(steps)
