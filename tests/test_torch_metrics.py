"""Port parity for `zebrapose_tpu_torch/ops/metrics.py` against the JAX
package on the CPU: the same poses and model points (numpy, from a seed)
through both.

Tolerance 1e-4 relative on ADD/ADI (float32, op order only; ADI's
|a|² + |b|² - 2ab form cancels in both stacks alike). The host
aggregators are the same numpy code and must agree exactly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from zebrapose_tpu.ops import metrics as jm
from zebrapose_tpu_torch.ops import metrics as tm


def _poses(rng, n):
    R = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0]
                  for _ in range(n)])
    R *= np.sign(np.linalg.det(R))[:, None, None]
    t = np.concatenate([rng.uniform(-50, 50, (n, 2)),
                        rng.uniform(400, 800, (n, 1))], -1)
    return R.astype(np.float32), t.astype(np.float32)


@pytest.mark.parametrize("symmetric", [False, True])
def test_pose_errors_match_jax(symmetric):
    rng = np.random.default_rng(20)
    n, V = 5, 1100                     # V not a multiple of the ADI chunk
    points = rng.uniform(-40, 40, (V, 3)).astype(np.float32)
    R_gt, t_gt = _poses(rng, n)
    # estimates near the GT (the regime recall is decided in) and far
    d_R, _ = _poses(rng, n)
    R_est = np.where(np.arange(n)[:, None, None] < 3, R_gt, d_R @ R_gt)
    t_est = t_gt + rng.normal(0, 3, t_gt.shape).astype(np.float32)
    want = np.asarray(jax.vmap(
        lambda a, b, c, d: jm.pose_error(a, b, c, d, jnp.asarray(points),
                                         symmetric))(
        *map(jnp.asarray, (R_est, t_est, R_gt, t_gt))))
    got = tm.pose_error(*map(torch.from_numpy, (R_est, t_est, R_gt, t_gt,
                                                points)), symmetric).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_aggregators_match_jax():
    rng = np.random.default_rng(21)
    errors = np.concatenate([rng.uniform(0, 120, 50), [10000.0]])
    for frac in (0.1, 0.05, 0.02):
        assert tm.recall_at(errors, 80.0, frac) == jm.recall_at(
            errors, 80.0, frac)
    assert tm.recall_at(np.zeros(0), 80.0) == jm.recall_at(np.zeros(0), 80.0)
    np.testing.assert_array_equal(tm.auc_step(errors), jm.auc_step(errors))
    assert tm.auc_posecnn(errors / 1000) == jm.auc_posecnn(errors / 1000)
    assert np.isnan(tm.auc_posecnn(np.full(4, 0.5)))
