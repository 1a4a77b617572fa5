"""Ray-tracing operators of the PyTorch port: sampling, intersection,
plane, materials and the persistent kernel's host side."""
