"""The harness: finds a cell's files by name, drives the program through the
cell's traffic, reads clocks, the profiler's trace and the reference's
comparison, and prints the result line.  Imports nothing of JAX; the
program (``simplepathtracer_tpu_torch``) is imported from the checkout by
``program.load``, never by this package at import time."""
