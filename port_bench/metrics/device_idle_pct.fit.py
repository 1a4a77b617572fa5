"""Share of the traced fit step's interval in which no device operation
ran."""

from pb_core.readers import idle_pct


def read(run):
    return idle_pct(run)
