"""Soft-silhouette ``pixel_loss`` gradients through the regen route against
the JAX package's regen route: the port's regeneration kernels' plain
versions on the CPU, the JAX kernels in Pallas interpret mode.  Cases,
pixels compared and bounds as in ``test_torch_soft_route.py`` (the JAX
package's own: rtol 2e-3 / atol 2e-6 sphere-only, relative L2 < 0.05 with
the plane).  The plane case is ``test_torch_soft_regen_route_plane.py``:
one case per file, so the suite's workers run the two at once."""

import pytest
from torch_threads import one_torch_thread  # noqa: F401
from test_torch_soft_route import check_soft_gradients


@pytest.mark.parametrize("plane", [False], ids=["soft"])
def test_soft_regen_gradients_match_jax(plane):
    check_soft_gradients(plane, regen=True)
