"""Share of the traced frames' interval in which no device operation ran
(mean over the ranks where several chips render)."""

from pb_core.readers import idle_pct


def read(run):
    return idle_pct(run)
