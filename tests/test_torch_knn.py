"""Port parity, KNN: scorp_tpu_torch.ops.knn.knn_mean_dist2 against
scorp_tpu.ops.knn on the same points, for n <= 3, one block and several
blocks."""

import numpy as np
import pytest
import torch

from scorp_tpu.ops.knn import knn_mean_dist2 as jax_knn
from scorp_tpu_torch.ops.knn import knn_mean_dist2

torch.set_num_threads(1)


def _lattice_points(n, seed):
    """Coordinates on a 1/64 grid in [-1, 1]: every square, product and sum
    of |q|^2 + |p|^2 - 2 q.p is exact in f32, so the two packages' results
    may differ only by the rounding of the final mean of 3 (~1 ulp),
    whatever order their sums take. Duplicates (distance 0) occur."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-64, 65, (n, 3)) / 64.0).astype(np.float32)


@pytest.mark.parametrize("n,q_block,p_block", [
    (2, 1024, 16384),     # n <= k: every other point is a neighbour
    (3, 1024, 16384),
    (500, 1024, 16384),   # one block
    (700, 128, 256),      # several query and point blocks, ragged last ones
])
def test_knn_matches_jax_exactly(n, q_block, p_block):
    pts = _lattice_points(n, n)
    ref = np.asarray(jax_knn(pts))
    got = knn_mean_dist2(pts, q_block=q_block, p_block=p_block).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


def test_knn_random_points_against_float64_brute_force():
    """Arbitrary f32 points: |q|^2 + |p|^2 - 2 q.p cancels, so both
    packages carry an absolute error up to ~1e-6 x max|p|^2; held against a
    float64 brute force at that bound."""
    pts = np.random.default_rng(0).uniform(-1, 1, (600, 3)).astype(np.float32)
    d2 = ((pts[:, None].astype(np.float64) - pts[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    ref = np.sort(d2, axis=1)[:, :3].mean(1)
    got = knn_mean_dist2(torch.from_numpy(pts), q_block=256, p_block=128).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=3e-6 * 3.0)
    assert got.dtype == np.float32 and got.shape == (600,)
