"""Multi-device and multi-process rendering on ``torch.distributed``: meshes,
the sharded render, the sharded gradient (counterpart of the JAX package's
``parallel/``; see ``sharding.py``)."""

from .distributed import (  # noqa: F401
    initialize_cluster,
    local_tile_slice,
    make_multihost_mesh,
    spawn_local,
)
from .sharding import (  # noqa: F401
    gather_tiles,
    loss_and_grad_sharded,
    make_mesh,
    merge_scene,
    render_accum_sharded,
    render_sharded,
    split_scene,
    train_step_sharded,
)
