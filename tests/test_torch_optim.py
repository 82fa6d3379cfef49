"""Port parity: pose-only optimization, the Schur BA core and the two-view
initializer (os1_tpu_torch.optim, os1_tpu_torch.solvers).

Same numpy inputs into both packages. Iterative float32 solves accumulate
rounding from sums taken in another order: the pose solve agrees to atol
1e-4, the 10-iteration BA to atol 5e-4 on poses (translations ~0.5) and 1e-3
on points (depth ~6); inlier classifications agree exactly (the observations
sit well away from the chi2 gates). The initializer's RANSAC draw is
injected: the port's sampler replays the JAX hypothesis indices of the same
key. Its 8-point fits take the smallest eigenvector of a 9x9 float32 normal
matrix, which is ill-conditioned: two LAPACK builds agree on the chosen
hypothesis but not in the last bits of F (measured: best scores differ by
~1e-4 relative, 232 vs 236 good points). So the initializer is held to the
same decision (success, model) and to atol 5e-3 on its pose, 3% on the good
count and 97% agreement of the good mask, on scenes where the fit is well
conditioned (the pose of a narrow-depth scene moved by up to 0.13 between the
two builds).
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from os1_tpu.geometry import se3 as jse3  # noqa: E402
from os1_tpu.optim import ba_core as jba  # noqa: E402
from os1_tpu.optim import pose_opt as jpo  # noqa: E402
from os1_tpu.solvers import initializer as jinit  # noqa: E402
from os1_tpu_torch.optim import ba_core as tba  # noqa: E402
from os1_tpu_torch.optim import pose_opt as tpo  # noqa: E402
from os1_tpu_torch.solvers import initializer as tinit  # noqa: E402

INTR = np.array([400.0, 400.0, 320.0, 240.0], np.float32)


def _t(x):
    x = np.array(x)
    return torch.from_numpy(x)


def _pose(xi):
    return np.asarray(jse3.exp(jnp.asarray(np.asarray(xi, np.float32))))


def _project(T, X):
    pc = X @ T[:3, :3].T + T[:3, 3]
    return (pc[..., :2] / pc[..., 2:] * INTR[:2] + INTR[2:]).astype(np.float32)


@pytest.mark.parametrize("sched", [(3, 4, False), (4, 10, True)])
def test_optimize_pose(sched):
    rng = np.random.default_rng(0)
    n = 400
    X = np.concatenate([rng.uniform(-3, 3, (n, 2)), rng.uniform(3, 9, (n, 1))], 1).astype(np.float32)
    T_true = _pose([0.1, -0.05, 0.2, 0.02, -0.03, 0.01])
    uv = _project(T_true, X) + rng.normal(0, 0.5, (n, 2)).astype(np.float32)
    uv[:40] += rng.uniform(30, 60, (40, 2)).astype(np.float32)  # gross outliers
    s2 = (1.2 ** (2 * rng.integers(0, 3, n))).astype(np.float32)
    valid = rng.random(n) < 0.95
    T0 = _pose([0.08, -0.03, 0.17, 0.0, -0.02, 0.0])
    r, i, ar = sched
    rj = jpo.optimize_pose(*(jnp.asarray(a) for a in (T0, X, uv, s2, valid, INTR)),
                           rounds=r, iters_per_round=i, accept_reject=ar)
    rt = tpo.optimize_pose(*(_t(a) for a in (T0, X, uv, s2, valid, INTR)),
                           rounds=r, iters_per_round=i, accept_reject=ar)
    np.testing.assert_allclose(rt.Tcw.numpy(), np.asarray(rj.Tcw), atol=1e-4)
    np.testing.assert_array_equal(rt.inlier.numpy(), np.asarray(rj.inlier))
    assert int(rt.n_inliers) == int(rj.n_inliers) > 300
    np.testing.assert_allclose(float(rt.chi2), float(rj.chi2), rtol=1e-3)


def test_ba_core():
    rng = np.random.default_rng(1)
    C, P, O = 4, 96, 4
    cams = np.stack([_pose([0.15 * c, 0.02 * c, 0.0, 0.0, 0.02 * c, 0.0]) for c in range(C)])
    X = np.concatenate([rng.uniform(-2, 2, (P, 2)), rng.uniform(4, 8, (P, 1))], 1).astype(np.float32)
    obs_cam = np.tile(np.arange(O), (P, 1)).astype(np.int32)
    obs_uv = np.stack([_project(cams[c], X) for c in range(O)], 1) + rng.normal(0, 0.5, (P, O, 2))
    obs_uv = obs_uv.astype(np.float32)
    obs_valid = rng.random((P, O)) < 0.9
    obs_valid[:, :2] = True
    s2 = np.ones((P, O), np.float32)
    cam_init = cams.copy()
    cam_init[2:] = np.stack([_pose([0.01, -0.01, 0.02, 0.005, 0, 0]) @ c for c in cams[2:]])
    X0 = (X + rng.normal(0, 0.05, X.shape)).astype(np.float32)
    fixed = np.array([True, True, False, False])
    pv = np.ones(P, bool)
    pv[-5:] = False
    fields = dict(cam_T=cam_init, cam_fixed=fixed, points=X0, point_valid=pv, obs_cam=obs_cam,
                  obs_uv=obs_uv, obs_sigma2=s2, obs_valid=obs_valid, intr=INTR)
    pj = jba.BAProblem(**{k: jnp.asarray(v) for k, v in fields.items()})
    fields["obs_cam"] = obs_cam.astype(np.int64)
    pt = tba.BAProblem(**{k: _t(v) for k, v in fields.items()})
    sj, st = jba.ba_begin(pj), tba.ba_begin(pt)
    for _ in range(2):
        sj, st = jba.ba_iterate(pj, sj, 5), tba.ba_iterate(pt, st, 5)
    rj, rt = jba.ba_result(pj, sj), tba.ba_result(pt, st)
    np.testing.assert_allclose(rt.cam_T.numpy(), np.asarray(rj.cam_T), atol=5e-4)
    np.testing.assert_allclose(rt.points.numpy(), np.asarray(rj.points), atol=1e-3)
    np.testing.assert_array_equal(rt.obs_inlier.numpy(), np.asarray(rj.obs_inlier))
    np.testing.assert_allclose(float(rt.cost), float(rj.cost), rtol=1e-3)
    assert float(rt.cost) < float(tba.ba_begin(pt).cost)


class ReplaySampler:
    """The port's sampler seam, replaying jax.random draws: the first call
    gets the homography key, the second the fundamental key of split(key)."""

    def __init__(self, key):
        self.keys = list(jax.random.split(key))

    def __call__(self, valid, iters, k):
        idx = jinit._sample_indices(self.keys.pop(0), jnp.asarray(valid.numpy()), iters, k)
        return torch.from_numpy(np.asarray(idx).astype(np.int64))


@pytest.mark.parametrize("scene", ["general", "planar"])
def test_initialize_two_view_with_injected_samples(scene):
    rng = np.random.default_rng(2)
    n = 300
    z = rng.uniform(2, 10, (n, 1)) if scene == "general" else np.full((n, 1), 6.0)
    X = np.concatenate([rng.uniform(-4, 4, (n, 2)), z], 1).astype(np.float32)
    T2 = _pose([0.4, 0.03, 0.05, 0.01, -0.06, 0.02])
    x1 = _project(np.eye(4, dtype=np.float32), X) + rng.normal(0, 0.2, (n, 2)).astype(np.float32)
    x2 = _project(T2, X) + rng.normal(0, 0.2, (n, 2)).astype(np.float32)
    x2[:30] = rng.uniform(0, 640, (30, 2))  # mismatches
    valid = rng.random(n) < 0.9
    K = np.array([[400, 0, 320], [0, 400, 240], [0, 0, 1]], np.float32)
    key = jax.random.PRNGKey(7)
    rj = jinit.initialize_two_view(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid),
                                   jnp.asarray(K), key)
    rt = tinit.initialize_two_view(_t(x1), _t(x2), _t(valid), _t(K), ReplaySampler(key))
    assert bool(rt.success) == bool(rj.success) is True
    assert bool(rt.used_homography) == bool(rj.used_homography)
    assert abs(int(rt.n_good) - int(rj.n_good)) <= 0.03 * int(rj.n_good)
    np.testing.assert_allclose(float(rt.rh), float(rj.rh), rtol=5e-3)
    np.testing.assert_allclose(rt.T21.numpy(), np.asarray(rj.T21), atol=5e-3)
    assert (rt.good.numpy() == np.asarray(rj.good)).mean() >= 0.97


def test_gumbel_sampler_draws_distinct_valid_indices():
    valid = torch.zeros(100, dtype=torch.bool)
    valid[::3] = True
    idx = tinit.GumbelSampler(seed=3, device="cpu")(valid, 200, 8)
    assert idx.shape == (200, 8)
    assert bool(valid[idx].all())
    assert all(len(set(row.tolist())) == 8 for row in idx)
