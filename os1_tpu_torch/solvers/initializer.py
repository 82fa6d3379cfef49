"""Two-view monocular bootstrap: batched RANSAC for homography and
fundamental models, model selection, and relative-pose reconstruction.
Port of os1_tpu/solvers/initializer.py (reference Initializer.cc).

The hypothesis draw is an argument: ``sampler(valid [N] bool, iters, k) ->
[iters, k] int64`` distinct indices of valid matches, called once for the
homography hypotheses and then once for the fundamental ones. The default,
:class:`GumbelSampler`, draws a Gumbel top-k from a ``torch.Generator`` on the
frame's device; a test passes a sampler that replays another draw.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..geometry import se3, triangulation

CHI2_H = 5.991
CHI2_F = 3.841
SCORE_TH = 5.991
RANSAC_ITERS = 200
SAMPLE = 8


class InitResult(NamedTuple):
    success: torch.Tensor  # bool scalar
    used_homography: torch.Tensor  # bool scalar
    T21: torch.Tensor  # [4, 4] pose of frame 2 w.r.t. frame 1
    points: torch.Tensor  # [N, 3] in frame-1/world coords
    good: torch.Tensor  # [N] bool
    n_good: torch.Tensor  # int
    rh: torch.Tensor  # model-selection score ratio


class GumbelSampler:
    """[iters, k] distinct indices of valid matches by Gumbel top-k per row,
    from an explicit generator (the reference draws from jax.random)."""

    def __init__(self, seed: int = 0, device: str | torch.device = "cuda"):
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(seed)

    def __call__(self, valid: torch.Tensor, iters: int, k: int) -> torch.Tensor:
        u = torch.rand((iters, valid.shape[0]), generator=self.generator,
                       device=valid.device, dtype=torch.float32)
        u = torch.clamp(u, min=1e-12, max=1.0 - 1e-7)
        g = -torch.log(-torch.log(u))
        g = torch.where(valid[None, :], g, torch.full_like(g, float("-inf")))
        return torch.topk(g, k, dim=1).indices


def _normalize(xy, valid):
    """Hartley normalization over valid points (mean / mean abs deviation)."""
    w = valid.to(torch.float32)
    n = torch.clamp(torch.sum(w), min=1.0)
    mean = torch.sum(xy * w[:, None], dim=0) / n
    dev = torch.sum(torch.abs(xy - mean) * w[:, None], dim=0) / n
    s = 1.0 / torch.clamp(dev, min=1e-8)
    xn = (xy - mean) * s
    z = torch.zeros_like(s[0])
    o = torch.ones_like(s[0])
    T = torch.stack([
        torch.stack([s[0], z, -mean[0] * s[0]]),
        torch.stack([z, s[1], -mean[1] * s[1]]),
        torch.stack([z, z, o]),
    ])
    return xn, T


def _fit_h_batch(x1, x2):
    """Batched homography DLT: [I, 8, 2] x1 -> x2. Returns [I, 3, 3]."""
    zeros = torch.zeros_like(x1[..., 0])
    ones = torch.ones_like(zeros)
    u, v = x1[..., 0], x1[..., 1]
    up, vp = x2[..., 0], x2[..., 1]
    row1 = torch.stack([zeros, zeros, zeros, -u, -v, -ones, vp * u, vp * v, vp], dim=-1)
    row2 = torch.stack([u, v, ones, zeros, zeros, zeros, -up * u, -up * v, -up], dim=-1)
    A = torch.cat([row1, row2], dim=1)  # [I, 16, 9]
    AtA = torch.einsum("ink,inl->ikl", A, A)
    _, vecs = torch.linalg.eigh(AtA)
    return vecs[..., :, 0].reshape(-1, 3, 3)


def _fit_f_batch(x1, x2):
    """Batched 8-point fundamental fit with rank-2 projection. [I, 3, 3]."""
    u, v = x1[..., 0], x1[..., 1]
    up, vp = x2[..., 0], x2[..., 1]
    ones = torch.ones_like(u)
    A = torch.stack([up * u, up * v, up, vp * u, vp * v, vp, u, v, ones], dim=-1)
    AtA = torch.einsum("ink,inl->ikl", A, A)
    _, vecs = torch.linalg.eigh(AtA)
    Fm = vecs[..., :, 0].reshape(-1, 3, 3)
    U, S, Vt = torch.linalg.svd(Fm)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    return U @ (S[..., None] * Vt)


def _homog(a):
    return torch.cat([a, torch.ones_like(a[:, :1])], dim=1)


def _score_h(H, xy1, xy2, valid, sigma2: float):
    """[I] scores + [I, N] inliers: symmetric transfer error."""
    Hinv = torch.linalg.inv_ex(H)[0]

    def transfer(M, a, b):
        p = torch.einsum("iuv,nv->inu", M, _homog(a))
        w = p[..., 2]
        w = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
        uv = p[..., :2] / w[..., None]
        return torch.sum((uv - b[None]) ** 2, dim=-1) / sigma2

    chi12 = transfer(H, xy1, xy2)
    chi21 = transfer(Hinv, xy2, xy1)
    in12 = (chi12 < CHI2_H) & valid[None, :]
    in21 = (chi21 < CHI2_H) & valid[None, :]
    zero = torch.zeros_like(chi12)
    score = (torch.sum(torch.where(in12, SCORE_TH - chi12, zero), dim=1)
             + torch.sum(torch.where(in21, SCORE_TH - chi21, zero), dim=1))
    return score, in12 & in21


def _score_f(Fm, xy1, xy2, valid, sigma2: float):
    """[I] scores + [I, N] inliers: epipolar line distance both directions."""
    ah1, ah2 = _homog(xy1), _homog(xy2)

    def linedist(lines, b):
        num = torch.einsum("inu,nu->in", lines[..., :2], b) + lines[..., 2]
        den = torch.sum(lines[..., :2] ** 2, dim=-1)
        return (num * num) / torch.clamp(den, min=1e-12)

    l2 = torch.einsum("iuv,nv->inu", Fm, ah1)
    l1 = torch.einsum("ivu,nv->inu", Fm, ah2)
    chi2_2 = linedist(l2, xy2) / sigma2
    chi2_1 = linedist(l1, xy1) / sigma2
    in2 = (chi2_2 < CHI2_F) & valid[None, :]
    in1 = (chi2_1 < CHI2_F) & valid[None, :]
    zero = torch.zeros_like(chi2_2)
    score = (torch.sum(torch.where(in2, SCORE_TH - chi2_2, zero), dim=1)
             + torch.sum(torch.where(in1, SCORE_TH - chi2_1, zero), dim=1))
    return score, in1 & in2


def _unit(t):
    return t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True), min=1e-12)


def _decompose_f(Fm, K):
    """4 candidate [R|t] from the essential matrix. [4, 4, 4]."""
    E = K.T @ Fm @ K
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=Fm.dtype, device=Fm.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = _unit(U[:, 2])
    return torch.stack([se3.from_Rt(R1, t), se3.from_Rt(R1, -t),
                        se3.from_Rt(R2, t), se3.from_Rt(R2, -t)])


def _decompose_h(H, K):
    """8 candidate [R|t] from a homography (Faugeras SVD method). [8, 4, 4]."""
    A = torch.linalg.inv(K) @ H @ K
    U, d, Vt = torch.linalg.svd(A)
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d2, d3 = d[0], d[1], d[2]
    eps = 1e-8
    den = torch.clamp(d1 * d1 - d3 * d3, min=eps)
    x1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / den, min=0.0))
    x3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / den, min=0.0))
    signs = torch.tensor([[1.0, 1.0], [1.0, -1.0], [-1.0, 1.0], [-1.0, -1.0]],
                         dtype=H.dtype, device=H.device)
    e1, e3 = signs[:, 0], signs[:, 1]
    zero, one = torch.zeros_like(e1), torch.ones_like(e1)

    def candidates(sin_t, cos_t, rp_sign, tz_sign, scale):
        st = e1 * e3 * sin_t
        c = cos_t * one
        Rp = torch.stack([
            torch.stack([c, zero, -rp_sign * st], dim=-1),
            torch.stack([zero, rp_sign * one, zero], dim=-1),
            torch.stack([st, zero, rp_sign * c], dim=-1),
        ], dim=-2)  # [4, 3, 3]
        tp = torch.stack([e1 * x1, 0.0 * e1, tz_sign * e3 * x3], dim=-1) * scale
        R = s * U @ Rp @ Vt
        t = (U @ tp[..., None])[..., 0]
        return se3.from_Rt(R, _unit(t))

    # Case d' = d2 > 0.
    sin_t = (d1 - d3) * x1 * x3 / torch.clamp(d2, min=eps)
    cos_t = (d2 * d2 + d1 * d3) / torch.clamp(d2 * (d1 + d3), min=eps)
    pos = candidates(sin_t, cos_t, 1.0, -1.0, d1 - d3)
    # Case d' = -d2.
    sin_p = (d1 + d3) * x1 * x3 / torch.clamp(d2, min=eps)
    cos_p = (d1 * d3 - d2 * d2) / torch.clamp(d2 * (d1 - d3), min=eps)
    neg = candidates(sin_p, cos_p, -1.0, 1.0, d1 + d3)
    return torch.cat([pos, neg], dim=0)


def _check_rt(T21, xy1, xy2, inlier, K, sigma2: float):
    """Cheirality + reprojection scoring of a batch of pose hypotheses
    T21 [B, 4, 4] over all matches (Initializer::CheckRT). Returns (n_good [B],
    good [B, N], parallax-deg of the 50th-best point [B], points [B, N, 3])."""
    B, n = T21.shape[0], xy1.shape[0]
    T1 = torch.eye(4, dtype=T21.dtype, device=T21.device)
    P1 = (K @ T1[:3, :]).expand(B, n, 3, 4)
    P2 = (K @ T21[:, :3, :])[:, None].expand(B, n, 3, 4)
    X = triangulation.triangulate_dlt(P1, P2, xy1.expand(B, n, 2), xy2.expand(B, n, 2))
    finite = torch.isfinite(X).all(dim=-1)
    pc1 = X
    pc2 = se3.transform(T21, X)
    cosp = triangulation.parallax_cosine(T1, T21, X)
    depth_ok = (pc1[..., 2] > 0) & (pc2[..., 2] > 0)

    def reproj(pc, xy):
        z = pc[..., 2]
        z = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
        u = K[0, 0] * pc[..., 0] / z + K[0, 2]
        v = K[1, 1] * pc[..., 1] / z + K[1, 2]
        return (u - xy[..., 0]) ** 2 + (v - xy[..., 1]) ** 2

    err_ok = (reproj(pc1, xy1) < 4.0 * sigma2) & (reproj(pc2, xy2) < 4.0 * sigma2)
    good = inlier & finite & depth_ok & err_ok & (cosp < 0.99998)
    n_good = torch.sum(good, dim=-1)
    cos_sorted = torch.sort(torch.where(good, cosp, torch.full_like(cosp, float("-inf"))),
                            dim=-1, descending=True).values
    idx = torch.clamp(torch.minimum(torch.full_like(n_good, 50), n_good) - 1, 0, n - 1)
    cos_sel = torch.clamp(torch.gather(cos_sorted, 1, idx[:, None])[:, 0], -1.0, 1.0)
    parallax_deg = torch.arccos(cos_sel) * (180.0 / math.pi)
    parallax_deg = torch.where(n_good > 0, parallax_deg, torch.zeros_like(parallax_deg))
    return n_good, good, parallax_deg, X


def initialize_two_view(xy1, xy2, valid, K, sampler, sigma: float = 1.0,
                        min_parallax_deg: float = 1.0,
                        min_triangulated: int = 50) -> InitResult:
    """Full two-view initialization from aligned match arrays.

    xy1, xy2: [N, 2] undistorted pixel coords of matched features (row i of
    xy2 corresponds to row i of xy1); valid: [N] match mask; K: [3, 3]."""
    sigma2 = sigma * sigma
    n_valid = torch.sum(valid)
    x1n, T1n = _normalize(xy1, valid)
    x2n, T2n = _normalize(xy2, valid)
    idx_h = sampler(valid, RANSAC_ITERS, SAMPLE)
    idx_f = sampler(valid, RANSAC_ITERS, SAMPLE)

    Hn = _fit_h_batch(x1n[idx_h], x2n[idx_h])
    H = torch.linalg.inv(T2n) @ Hn @ T1n
    h_scores, h_inliers = _score_h(H, xy1, xy2, valid, sigma2)
    Fn = _fit_f_batch(x1n[idx_f], x2n[idx_f])
    Fm = T2n.T @ Fn @ T1n
    f_scores, f_inliers = _score_f(Fm, xy1, xy2, valid, sigma2)

    bh = torch.argmax(h_scores)
    bf = torch.argmax(f_scores)
    SH, SF = h_scores[bh], f_scores[bf]
    rh = SH / torch.clamp(SH + SF, min=1e-8)
    use_h = rh > 0.40  # Initializer.cc:112-118

    cands = torch.cat([_decompose_f(Fm[bf], K), _decompose_h(H[bh], K)], dim=0)  # [12, 4, 4]
    inl = torch.where(use_h, h_inliers[bh], f_inliers[bf])
    n_good, good, parallax, X = _check_rt(cands, xy1, xy2, inl, K, sigma2)

    fam = torch.arange(12, device=xy1.device) < 4  # True = F-candidates
    allowed = torch.where(use_h, ~fam, fam)
    n_good_m = torch.where(allowed, n_good, torch.full_like(n_good, -1))
    best = torch.argmax(n_good_m)
    best_n = n_good_m[best]
    n_inl = torch.sum(inl)
    second_n = torch.sort(n_good_m, descending=True).values[1]
    min_good = torch.clamp((0.9 * n_inl.to(torch.float32)).to(torch.int64), min=min_triangulated)
    ratio = torch.where(use_h, 0.75, 0.7)
    distinct = second_n.to(torch.float32) < ratio * best_n.to(torch.float32)
    success = ((best_n >= min_good) & distinct & (parallax[best] > min_parallax_deg)
               & (n_valid >= SAMPLE))
    return InitResult(success=success, used_homography=use_h, T21=cands[best],
                      points=X[best], good=good[best], n_good=best_n, rh=rh)
