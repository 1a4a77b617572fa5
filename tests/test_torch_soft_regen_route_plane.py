"""The ground-plane case of ``test_torch_soft_regen_route.py`` (soft 0.05,
Russian roulette from bounce 2, the crossing coin live): soft-silhouette
``pixel_loss`` gradients through the regen route against the JAX package's
regen route, with that file's pixels and bounds.  A file of its own so the
suite's workers run the two cases at once."""

import pytest
from torch_threads import one_torch_thread  # noqa: F401
from test_torch_soft_route import check_soft_gradients


@pytest.mark.parametrize("plane", [True], ids=["soft-plane-rr"])
def test_soft_regen_gradients_match_jax(plane):
    check_soft_gradients(plane, regen=True)
