"""Camera models: pinhole (radial-tangential, 4/5/8 coefficients) and fisheye
(equidistant projection). Port of os1_tpu/geometry/camera.py.

A single ``Camera`` carries an 8-vector of distortion coefficients
``[k1, k2, p1, p2, k3, k4, k5, k6]`` (unused entries zero) and a ``fisheye``
flag; both distortion paths are evaluated and selected with ``where``, as in
the reference package. Every field is a tensor on the camera's device.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Camera(NamedTuple):
    """Intrinsic calibration. All fields are 0-d tensors except ``dist`` (8,)."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    dist: torch.Tensor  # [k1, k2, p1, p2, k3, k4, k5, k6]
    fisheye: torch.Tensor  # bool: equidistant model if True
    width: torch.Tensor
    height: torch.Tensor

    @staticmethod
    def make(fx, fy, cx, cy, dist=None, fisheye=False, width=640, height=480,
             device: torch.device | str = "cpu") -> "Camera":
        d = torch.zeros(8, dtype=torch.float32, device=device)
        if dist is not None:
            dist = torch.as_tensor(dist, dtype=torch.float32, device=device)
            d[: dist.shape[0]] = dist

        def f32(v):
            return torch.tensor(float(v), dtype=torch.float32, device=device)

        return Camera(fx=f32(fx), fy=f32(fy), cx=f32(cx), cy=f32(cy), dist=d,
                      fisheye=torch.tensor(bool(fisheye), device=device),
                      width=f32(width), height=f32(height))

    def to(self, device) -> "Camera":
        return Camera(*(f.to(device) for f in self))

    @property
    def device(self) -> torch.device:
        return self.fx.device

    @property
    def K(self) -> torch.Tensor:
        """3x3 intrinsic matrix (no distortion)."""
        z = torch.zeros_like(self.fx)
        o = torch.ones_like(self.fx)
        return torch.stack([
            torch.stack([self.fx, z, self.cx]),
            torch.stack([z, self.fy, self.cy]),
            torch.stack([z, z, o]),
        ])


def _distort_pinhole(xn: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    k1, k2, p1, p2, k3, k4, k5, k6 = [dist[..., i] for i in range(8)]
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    r4 = r2 * r2
    r6 = r4 * r2
    radial = (1.0 + k1 * r2 + k2 * r4 + k3 * r6) / (1.0 + k4 * r2 + k5 * r4 + k6 * r6)
    dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([x * radial + dx, y * radial + dy], dim=-1)


def _distort_fisheye(xn: torch.Tensor) -> torch.Tensor:
    """Equidistant projection: distorted radius = theta (angle from axis)."""
    x, y = xn[..., 0], xn[..., 1]
    r = torch.sqrt(x * x + y * y)
    small = r < 1e-8
    safe_r = torch.where(small, torch.ones_like(r), r)
    scale = torch.where(small, torch.ones_like(r), torch.arctan(r) / safe_r)
    return xn * scale[..., None]


def _undistort_fisheye(xd: torch.Tensor) -> torch.Tensor:
    """Inverse equidistant: multiply by tan(theta_d)/theta_d."""
    x, y = xd[..., 0], xd[..., 1]
    theta_d = torch.sqrt(x * x + y * y)
    small = theta_d < 1e-8
    safe = torch.where(small, torch.ones_like(theta_d), theta_d)
    safe = torch.clamp(safe, max=math.pi / 2.0 - 1e-3)
    scale = torch.where(small, torch.ones_like(theta_d), torch.tan(safe) / safe)
    return xd * scale[..., None]


def distort(cam: Camera, xn: torch.Tensor) -> torch.Tensor:
    """Normalized undistorted (..., 2) -> normalized distorted (..., 2)."""
    return torch.where(cam.fisheye, _distort_fisheye(xn), _distort_pinhole(xn, cam.dist))


def undistort(cam: Camera, xd: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Normalized distorted (..., 2) -> undistorted (..., 2): fixed-point
    inversion of the rational model (as cv::undistortPoints), closed-form
    fisheye."""
    k1, k2, p1, p2, k3, k4, k5, k6 = [cam.dist[..., i] for i in range(8)]
    x = xd
    for _ in range(iters):
        xi, yi = x[..., 0], x[..., 1]
        r2 = xi * xi + yi * yi
        r4 = r2 * r2
        r6 = r4 * r2
        radial = (1.0 + k1 * r2 + k2 * r4 + k3 * r6) / (1.0 + k4 * r2 + k5 * r4 + k6 * r6)
        dx = 2.0 * p1 * xi * yi + p2 * (r2 + 2.0 * xi * xi)
        dy = p1 * (r2 + 2.0 * yi * yi) + 2.0 * p2 * xi * yi
        x = torch.stack([(xd[..., 0] - dx) / radial, (xd[..., 1] - dy) / radial], dim=-1)
    return torch.where(cam.fisheye, _undistort_fisheye(xd), x)


def _safe_z(pc: torch.Tensor) -> torch.Tensor:
    z = pc[..., 2]
    return torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)


def project(cam: Camera, pc: torch.Tensor) -> torch.Tensor:
    """Camera-frame 3D points (..., 3) -> distorted pixel coords (..., 2)."""
    xd = distort(cam, pc[..., :2] / _safe_z(pc)[..., None])
    return torch.stack([cam.fx * xd[..., 0] + cam.cx, cam.fy * xd[..., 1] + cam.cy], dim=-1)


def project_ideal(cam: Camera, pc: torch.Tensor) -> torch.Tensor:
    """Project WITHOUT distortion, for already-undistorted keypoint coords."""
    z = _safe_z(pc)
    return torch.stack([cam.fx * pc[..., 0] / z + cam.cx, cam.fy * pc[..., 1] / z + cam.cy], dim=-1)


def pixel_to_normalized(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    """Distorted pixels (..., 2) -> undistorted normalized coords (..., 2)."""
    xd = torch.stack([(uv[..., 0] - cam.cx) / cam.fx, (uv[..., 1] - cam.cy) / cam.fy], dim=-1)
    return undistort(cam, xd)


def undistort_pixels(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    """Distorted pixels -> undistorted pixel coords (reference mvKeysUn)."""
    xn = pixel_to_normalized(cam, uv)
    return torch.stack([cam.fx * xn[..., 0] + cam.cx, cam.fy * xn[..., 1] + cam.cy], dim=-1)


def unproject_ray(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    """Distorted pixels (..., 2) -> unit ray directions (..., 3), camera frame."""
    xn = pixel_to_normalized(cam, uv)
    ray = torch.cat([xn, torch.ones_like(xn[..., :1])], dim=-1)
    return ray / torch.linalg.norm(ray, dim=-1, keepdim=True)


def in_image(cam: Camera, uv: torch.Tensor, margin: float = 0.0) -> torch.Tensor:
    """Boolean mask of pixels inside the image bounds (minus margin)."""
    return ((uv[..., 0] >= margin) & (uv[..., 0] < cam.width - margin)
            & (uv[..., 1] >= margin) & (uv[..., 1] < cam.height - margin))
