"""``inverse.fit_sharded`` over a 2-rank gloo mesh (1 x 2), as
``tests/test_inverse.py:220`` holds the JAX package's: it recovers the
albedo (loss below 0.6 of its start, albedo error below 0.7 of its start),
and a fit that dies after its step-8 snapshot (``os._exit``) and resumes in
a new job is bit for bit the uninterrupted fit (leaves and losses): rank 0
writes the snapshot, every rank reads it."""

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

import torch_dist_jobs as jobs


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fit_sharded")
    snap = str(tmp / "sfit.npz")
    first = jobs.run_job(jobs.fit_job, 2, tmp, snap, False)
    second = jobs.run_job(jobs.fit_job, 2, tmp, snap, True)
    full = [dict(np.load(f"{first}/full{r}.npz")) for r in range(2)]
    return full, [dict(np.load(f"{second}/resumed{r}.npz")) for r in range(2)]


def test_fit_sharded_recovers_albedo(fits):
    full, _ = fits
    truth, start, _, _, _ = jobs.fit_setup()
    for r in full:
        np.testing.assert_array_equal(r["albedo"], full[0]["albedo"])
        losses = r["losses"]
        assert len(losses) == jobs.FIT_STEPS
        assert losses[-1] < losses[0] * 0.6, losses[::4]
    err_before = (start.albedo - truth.albedo).abs().mean().item()
    err_after = np.abs(full[0]["albedo"] - truth.albedo.numpy()).mean()
    assert err_after < err_before * 0.7, (err_before, err_after)


def test_fit_sharded_resumes_bit_identically(fits):
    full, resumed = fits
    for a, b in zip(full, resumed):
        np.testing.assert_array_equal(b["albedo"], a["albedo"])
        np.testing.assert_array_equal(b["losses"], a["losses"])
