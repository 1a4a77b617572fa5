"""The port's multi-process helpers (``parallel/distributed.py``), as
``tests/test_distributed.py`` holds the JAX package's: ``initialize_cluster``
does nothing without a configured job, ``make_multihost_mesh`` gives the
right shapes and refuses the wrong ones, and the tiles' ``local_tile_slice``
rows cover every pixel once.  The meshes run in one 4-rank gloo job
(``torch_dist_jobs.distributed_job``)."""

import numpy as np
import pytest
import torch.distributed as dist
from torch_threads import one_torch_thread  # noqa: F401

import torch_dist_jobs as jobs
from simplepathtracer_tpu_torch import parallel


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = jobs.run_job(jobs.distributed_job, 4, tmp_path_factory.mktemp("distributed"))
    return [dict(np.load(f"{out}/rank{r}.npz")) for r in range(4)]


def test_initialize_cluster_single_process_noop(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    parallel.initialize_cluster()  # must not raise without a configured job
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialized process group"):
        parallel.make_mesh()


def test_make_multihost_mesh_shapes(ranks):
    for r in ranks:
        assert list(r["shape_2"]) == [2, 2]
        assert list(r["shape_1"]) == [4, 1]
        # 4 % 3 != 0; 0 samples; 4 samples on a node of 2 processes.
        assert list(r["errors"]) == [3, 0, 4]


def test_local_tile_slice_covers_all_pixels(ranks):
    for key, n, tiles in (("slice_2", 4096, 2), ("slice_1", 800, 4)):
        seen = np.zeros(n, int)
        for rank, r in enumerate(ranks):
            start, size = (int(x) for x in r[key])
            assert size == n // tiles
            seen[start:start + size] += 1
        # Each tile's rows are held by the ranks of its samples group.
        assert (seen == 4 // tiles).all()


def test_a_dead_rank_fails_the_job(tmp_path):
    with pytest.raises(Exception, match="exit code 3|exited with"):
        jobs.run_job(jobs.dead_peer_job, 2, tmp_path)


def test_a_job_past_its_time_is_killed(tmp_path, monkeypatch):
    monkeypatch.setattr(jobs, "JOB_TIMEOUT", 4.0)
    with pytest.raises(TimeoutError, match="did not end within 4.0 s"):
        jobs.run_job(jobs.sleeping_job, 2, tmp_path, 60.0)
