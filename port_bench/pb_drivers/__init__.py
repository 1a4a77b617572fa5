"""Drivers: one module per program entry point a traffic mix can name
(``traffic/<mix>.json``'s ``entry``).  Each has ``measure(ctx)`` (set-up and
the measured window; returns the run's records) and ``check(ctx, run)``
(the comparison with the reference, after the window: a list of (name,
value, limit))."""
