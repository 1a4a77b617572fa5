"""One torch intra-op thread for the port's CPU tests.

The suite runs several test processes at once (pytest-xdist), and torch's
thread pools, oversubscribed across them, run the port's small CPU
tensors several times slower than one thread does.  A test module applies
it by importing the fixture:

    from torch_threads import one_torch_thread  # noqa: F401

Module scope, so the module's own module-scoped fixtures (its JAX and port
references) run under it too.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
