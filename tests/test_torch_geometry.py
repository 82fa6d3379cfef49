"""Port parity: SE3, camera models and triangulation (os1_tpu_torch.geometry).

Same numpy inputs into both packages. Float32 results agree to a few ulps of
their magnitude: atol 1e-5 on unit-scale quantities (rotations, normalized
coordinates), 1e-3 on pixels (values up to ~1e3), rtol 1e-4 on triangulated
points (a 3x3 Cramer solve conditioned by the parallax).
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from os1_tpu.geometry import camera as jcam  # noqa: E402
from os1_tpu.geometry import se3 as jse3  # noqa: E402
from os1_tpu.geometry import triangulation as jtri  # noqa: E402
from os1_tpu_torch.geometry import camera as tcam  # noqa: E402
from os1_tpu_torch.geometry import se3 as tse3  # noqa: E402
from os1_tpu_torch.geometry import triangulation as ttri  # noqa: E402


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _xi(rng, n, rot=1.0):
    xi = rng.normal(0, 1, (n, 6)).astype(np.float32)
    xi[:, 3:] *= rot
    xi[:3, 3:] = [[0, 0, 0], [1e-6, 0, 0], [0, 2.9, 0.5]]  # identity, tiny, near pi
    return xi


def test_se3_exp_log_inverse_transform():
    rng = np.random.default_rng(0)
    xi = _xi(rng, 64)
    Tj = np.asarray(jse3.exp(jnp.asarray(xi)))
    Tt = tse3.exp(_t(xi))
    np.testing.assert_allclose(Tt.numpy(), Tj, atol=1e-5)
    np.testing.assert_allclose(tse3.log(Tt).numpy(), np.asarray(jse3.log(jnp.asarray(Tj))),
                               atol=2e-4)
    np.testing.assert_allclose(tse3.inverse(Tt).numpy(), np.asarray(jse3.inverse(jnp.asarray(Tj))),
                               atol=1e-5)
    pts = rng.normal(0, 3, (64, 10, 3)).astype(np.float32)
    np.testing.assert_allclose(tse3.transform(Tt, _t(pts)).numpy(),
                               np.asarray(jse3.transform(jnp.asarray(Tj), jnp.asarray(pts))),
                               atol=1e-4)
    np.testing.assert_allclose(tse3.transform(Tt[0], _t(pts[0, 0])).numpy(),
                               np.asarray(jse3.transform(jnp.asarray(Tj[0]), jnp.asarray(pts[0, 0]))),
                               atol=1e-5)
    np.testing.assert_allclose(tse3.camera_center(Tt).numpy(),
                               np.asarray(jse3.camera_center(jnp.asarray(Tj))), atol=1e-4)


def test_se3_quaternion_and_normalize():
    rng = np.random.default_rng(1)
    R = np.asarray(jse3.so3_exp(jnp.asarray(rng.normal(0, 1.5, (50, 3)).astype(np.float32))))
    qj = np.asarray(jse3.to_quaternion(jnp.asarray(R)))
    qt = tse3.to_quaternion(_t(R)).numpy()
    np.testing.assert_allclose(qt, qj, atol=1e-5)
    np.testing.assert_allclose(tse3.from_quaternion(_t(qj)).numpy(),
                               np.asarray(jse3.from_quaternion(jnp.asarray(qj))), atol=1e-5)
    noisy = (R + rng.normal(0, 1e-3, R.shape)).astype(np.float32)
    np.testing.assert_allclose(tse3.normalize_rotation(_t(noisy)).numpy(),
                               np.asarray(jse3.normalize_rotation(jnp.asarray(noisy))), atol=1e-5)


CAMERAS = {
    "pinhole4": dict(dist=[-0.28, 0.07, 1e-3, -5e-4]),
    "pinhole5": dict(dist=[-0.28, 0.07, 1e-3, -5e-4, 0.02]),
    "pinhole8": dict(dist=[-0.2, 0.05, 1e-3, -5e-4, 0.01, 0.1, -0.02, 0.005]),
    "fisheye": dict(fisheye=True),
}


@pytest.mark.parametrize("name", sorted(CAMERAS))
def test_camera_models(name):
    kw = dict(fx=400.0, fy=410.0, cx=320.0, cy=240.0, width=640, height=480, **CAMERAS[name])
    cj = jcam.Camera.make(**kw)
    ct = tcam.Camera.make(**kw)
    np.testing.assert_allclose(ct.K.numpy(), np.asarray(cj.K))
    rng = np.random.default_rng(2)
    pc = np.concatenate([rng.uniform(-2, 2, (300, 2)), rng.uniform(1, 6, (300, 1))], 1).astype(np.float32)
    uv_j = np.asarray(jcam.project(cj, jnp.asarray(pc)))
    uv_t = tcam.project(ct, _t(pc)).numpy()
    np.testing.assert_allclose(uv_t, uv_j, atol=1e-3)
    np.testing.assert_allclose(tcam.project_ideal(ct, _t(pc)).numpy(),
                               np.asarray(jcam.project_ideal(cj, jnp.asarray(pc))), atol=1e-3)
    uv = rng.uniform(0, 640, (300, 2)).astype(np.float32)
    np.testing.assert_allclose(tcam.undistort_pixels(ct, _t(uv)).numpy(),
                               np.asarray(jcam.undistort_pixels(cj, jnp.asarray(uv))), atol=1e-3)
    np.testing.assert_allclose(tcam.unproject_ray(ct, _t(uv)).numpy(),
                               np.asarray(jcam.unproject_ray(cj, jnp.asarray(uv))), atol=1e-5)
    np.testing.assert_array_equal(tcam.in_image(ct, _t(uv_j), 2.0).numpy(),
                                  np.asarray(jcam.in_image(cj, jnp.asarray(uv_j), 2.0)))


def test_triangulation_validate_and_median_depth():
    rng = np.random.default_rng(3)
    K = np.array([[400, 0, 320], [0, 400, 240], [0, 0, 1]], np.float32)
    T1 = np.eye(4, dtype=np.float32)
    T2 = np.asarray(jse3.exp(jnp.asarray([0.3, 0.02, 0.05, 0.01, -0.05, 0.02], jnp.float32)))
    X = np.concatenate([rng.uniform(-2, 2, (200, 2)), rng.uniform(3, 8, (200, 1))], 1).astype(np.float32)

    def proj(T, P):
        pc = P @ T[:3, :3].T + T[:3, 3]
        return (pc[:, :2] / pc[:, 2:] * 400 + [320, 240]).astype(np.float32)

    x1 = proj(T1, X) + rng.normal(0, 0.5, (200, 2)).astype(np.float32)
    x2 = proj(T2, X) + rng.normal(0, 0.5, (200, 2)).astype(np.float32)
    P1 = np.broadcast_to(K @ T1[:3], (200, 3, 4)).astype(np.float32)
    P2 = np.broadcast_to(K @ T2[:3], (200, 3, 4)).astype(np.float32)
    Xj = np.asarray(jtri.triangulate_dlt(*(jnp.asarray(a) for a in (P1, P2, x1, x2))))
    Xt = ttri.triangulate_dlt(*(_t(a) for a in (P1, P2, x1, x2))).numpy()
    np.testing.assert_allclose(Xt, Xj, rtol=1e-4, atol=1e-4)

    cj = jcam.Camera.make(400.0, 400.0, 320.0, 240.0)
    ct = tcam.Camera.make(400.0, 400.0, 320.0, 240.0)
    s2 = np.ones(200, np.float32)
    vj = jtri.validate(jnp.asarray(T1), jnp.asarray(T2), jnp.asarray(Xj), jnp.asarray(x1),
                       jnp.asarray(x2), lambda p: jcam.project_ideal(cj, p),
                       lambda p: jcam.project_ideal(cj, p), jnp.asarray(s2), jnp.asarray(s2))
    vt = ttri.validate(_t(T1), _t(T2), _t(Xj), _t(x1), _t(x2), lambda p: tcam.project_ideal(ct, p),
                       lambda p: tcam.project_ideal(ct, p), _t(s2), _t(s2))
    np.testing.assert_array_equal(vt.valid.numpy(), np.asarray(vj.valid))
    np.testing.assert_allclose(vt.parallax_cos.numpy(), np.asarray(vj.parallax_cos), atol=1e-6)
    mask = rng.random(200) < 0.7
    mj = float(jtri.median_depth(jnp.asarray(T2), jnp.asarray(Xj), jnp.asarray(mask)))
    mt = float(ttri.median_depth(_t(T2), _t(Xj), torch.from_numpy(mask)))
    assert abs(mt - mj) <= 1e-5 * abs(mj)
