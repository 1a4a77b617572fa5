"""The ``fit_camera`` entry: ``inverse.fit_camera`` run as its users run it.
Set-up, window and comparison as ``fit``'s (the fitted leaves are the
camera's: origin, lookat, vfov_deg; the start moves the camera)."""

from pb_drivers.fit import check, measure  # noqa: F401
