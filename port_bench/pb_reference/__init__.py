"""The benchmark's plain reference: what the program's outputs are judged by.

Plain PyTorch and NumPy, written to the semantics of the path tracer the
program implements (the threefry2x32 streams, the cover scene's
distributions, the thin-lens camera, the hard and soft closest-hit scans,
the bounce and its scatter), frozen here so that no later change to the
program moves the yardstick.  Nothing in this package imports the program,
JAX or the JAX package, and nothing in it takes what the program has made:
it is handed the benchmark's own inputs (the sphere table, the camera, the
key) and works everything else out again.

Every function takes a ``dtype``: float32 is the configuration's precision;
the control (``control.py``) runs the same code in bfloat16.
"""
