"""Plain ORB extractor: the features the program's extractor must produce,
computed again from the image with plain PyTorch operations.

A frozen copy of the program's extractor as the configuration states it
(``os1_tpu_torch/features/orb.py`` with ``ops/image.py``, ``ops/fast.py``,
``ops/topk.py``, the plain gathers of ``ops/patches.py`` and the camera's
undistortion): the bilinear pyramid as bf16 products summed in float32,
FAST-9 margins in bf16 with the 20 -> 7 fallback, 3x3 suppression, the
balanced per-cell top-k, the intensity-centroid angle, the steered BRIEF
pattern on the 7-tap Gaussian blur with bf16 samples. It imports nothing of
the program.

``precision="bfloat16"`` is the control: the stages the configuration states
in float32 (the pyramid's levels, the blur's sums, the centroid moments)
computed in bfloat16 instead.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

BORDER = 19
PATCH = 31
BRIEF_RADIUS = 13.0
N_ORIENT = 64
PS = 32
PC = 15
HALF = 15
BITS = 256
CIRCLE = ((0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
          (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3))


def level_sizes(h, w, n_levels, scale):
    return [(int(round(h / scale**l)), int(round(w / scale**l))) for l in range(n_levels)]


def features_per_level(n_features, n_levels, scale):
    f = 1.0 / scale
    raw = np.array([f**l for l in range(n_levels)])
    raw = raw / raw.sum() * n_features
    counts = np.floor(raw).astype(int)
    counts[0] += n_features - counts.sum()
    return [int(c) for c in counts]


def _resize_matrix(n_in, n_out, n_pad):
    R = np.zeros((n_pad, n_in), np.float32)
    scale = n_in / n_out
    for i in range(n_out):
        src = (i + 0.5) * scale - 0.5
        j0 = int(np.floor(src))
        t = src - j0
        R[i, np.clip(j0, 0, n_in - 1)] += 1.0 - t
        R[i, np.clip(j0 + 1, 0, n_in - 1)] += t
    return R


def _brief_table(seed):
    rng = np.random.default_rng(seed)
    pat = np.clip(rng.normal(0.0, PATCH / 5.0, size=(BITS, 2, 2)),
                  -BRIEF_RADIUS, BRIEF_RADIUS).astype(np.float32)
    r = BRIEF_RADIUS + 1
    tables = []
    for a in range(N_ORIENT):
        th = 2.0 * np.pi * a / N_ORIENT
        c, s = np.cos(th), np.sin(th)
        x = pat[..., 0] * c - pat[..., 1] * s
        y = pat[..., 0] * s + pat[..., 1] * c
        xi = np.clip(np.round(x), -r, r).astype(np.int64) + PC
        yi = np.clip(np.round(y), -r, r).astype(np.int64) + PC
        tables.append((yi * PS + xi).reshape(-1))
    return np.stack(tables).astype(np.int32)


def _ic_weights():
    ys, xs = np.mgrid[0:PS, 0:PS]
    dy, dx = ys - PC, xs - PC
    disc = (dx * dx + dy * dy) <= (PATCH // 2) ** 2
    return (dx * disc).astype(np.float32), (dy * disc).astype(np.float32)


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _edge(n, pad, device):
    return torch.clamp(torch.arange(-pad, n + pad, device=device), 0, n - 1)


def _blur(img, work):
    r = 3.0
    x = np.arange(7, dtype=np.float64) - r
    k = np.exp(-(x * x) / 8.0)
    k = (k / k.sum()).astype(np.float32)
    h, w = img.shape[-2], img.shape[-1]
    x = img.to(work)[..., _edge(h, 3, img.device), :]
    acc = float(k[0]) * x[..., 0:h, :]
    for i in range(1, 7):
        acc = acc + float(k[i]) * x[..., i:i + h, :]
    x = acc[..., :, _edge(w, 3, img.device)]
    acc = float(k[0]) * x[..., :, 0:w]
    for i in range(1, 7):
        acc = acc + float(k[i]) * x[..., :, i:i + w]
    return acc.to(torch.float32)


def _fast_margin(img, hb, wb):
    img = img.to(torch.bfloat16)
    h, w = img.shape[-2], img.shape[-1]
    dev = img.device
    padded = img[..., _edge(h, 3, dev), :][..., :, _edge(w, 3, dev)]
    ring = [padded[..., 3 + dy: 3 + dy + h, 3 + dx: 3 + dx + w] for dx, dy in CIRCLE]

    def arc_min9(x):
        n = len(x)
        m2 = [torch.minimum(x[k], x[(k + 1) % n]) for k in range(n)]
        m4 = [torch.minimum(m2[k], m2[(k + 2) % n]) for k in range(n)]
        m8 = [torch.minimum(m4[k], m4[(k + 4) % n]) for k in range(n)]
        m9 = [torch.minimum(m8[k], x[(k + 8) % n]) for k in range(n)]
        out = m9[0]
        for k in range(1, n):
            out = torch.maximum(out, m9[k])
        return out

    margin = torch.maximum(arc_min9([r - img for r in ring]),
                           arc_min9([img - r for r in ring])).to(torch.float32)
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    hb = hb.reshape(-1, 1, 1)
    wb = wb.reshape(-1, 1, 1)
    inside = (ys >= 3) & (ys < hb - 3) & (xs >= 3) & (xs < wb - 3)
    return torch.where(inside, margin, torch.zeros_like(margin))


def _fast_scores(img, hi, lo, hb, wb):
    margin = _fast_margin(img, hb, wb)
    s_hi = torch.clamp(margin - hi, min=0.0)
    s_lo = torch.clamp(margin - lo, min=0.0)
    region = 32
    h, w = img.shape[-2], img.shape[-1]
    pad = F.pad(s_hi, (0, (region - w % region) % region, 0, (region - h % region) % region))
    hp, wp = pad.shape[-2] // region, pad.shape[-1] // region
    empty = pad.reshape(pad.shape[:-2] + (hp, region, wp, region)).amax(dim=(-3, -1)) <= 0.0
    empty = empty[..., :, None, :, None].expand(empty.shape[:-2] + (hp, region, wp, region))
    empty = empty.reshape(empty.shape[:-4] + (hp * region, wp * region))[..., :h, :w]
    peak = torch.amax(s_lo, dim=(-2, -1), keepdim=True)
    scores = torch.where(empty, s_lo / (1.0 + peak) * lo, s_hi)
    s4 = scores.reshape((-1, 1) + scores.shape[-2:])
    neigh = F.max_pool2d(s4, 3, stride=1, padding=1).reshape(scores.shape)
    return torch.where((scores >= neigh) & (scores > 0.0), scores, torch.zeros_like(scores))


def _cell_topk(scores, cell, k, n_out):
    L, h, w = scores.shape
    dev = scores.device
    s = F.pad(scores, (0, (cell - w % cell) % cell, 0, (cell - h % cell) % cell))
    hc, wc = s.shape[1] // cell, s.shape[2] // cell
    vals = s.reshape(L, hc, cell, wc, cell).permute(0, 1, 3, 2, 4).reshape(L, hc * wc, cell * cell)
    iota = torch.arange(vals.shape[-1], device=dev)
    top_s, top_i = [], []
    for _ in range(k):
        i = torch.argmax(vals, dim=-1)
        top_s.append(torch.gather(vals, -1, i[..., None])[..., 0])
        top_i.append(i.to(torch.int32))
        vals = torch.where(iota == i[..., None], torch.full_like(vals, float("-inf")), vals)
    top_s, top_i = torch.stack(top_s, -1), torch.stack(top_i, -1)
    m = torch.arange(hc * wc, dtype=torch.int32, device=dev)[None, :, None]
    ys = ((m // wc) * cell + top_i // cell).reshape(L, -1)
    xs = ((m % wc) * cell + top_i % cell).reshape(L, -1)
    rank = torch.arange(k, dtype=torch.int32, device=dev).expand(L, hc * wc, k).reshape(L, -1)
    flat = top_s.reshape(L, -1)
    valid = flat > 0.0
    q = torch.clamp(torch.round(flat * 4096.0), 0, (1 << 20) - 1).to(torch.int32)
    key = torch.where(valid, rank * (1 << 21) + ((1 << 20) - q),
                      torch.full_like(q, 2**31 - 1))
    order = torch.argsort(key, dim=1, stable=True)[:, :n_out]
    xy = torch.stack([torch.gather(xs, 1, order).to(torch.float32),
                      torch.gather(ys, 1, order).to(torch.float32)], dim=-1)
    return xy, torch.gather(valid, 1, order)


def _pack(bits):
    b = bits.reshape(bits.shape[:-1] + (8, 32)).to(torch.int64)
    x = (b << torch.arange(32, dtype=torch.int64, device=bits.device)).sum(-1)
    return x.cpu().numpy().astype(np.uint32)


def undistort_pixels(xy: np.ndarray, cam: dict, iters: int = 10) -> np.ndarray:
    """Distorted pixels [N, 2] -> undistorted pixels in float64, by the
    fixed-point inversion of the radial-tangential model."""
    fx, fy, cx, cy = cam["fx"], cam["fy"], cam["cx"], cam["cy"]
    k1, k2, p1, p2, k3 = (float(cam.get(k, 0.0)) for k in ("k1", "k2", "p1", "p2", "k3"))
    xd = (xy[:, 0].astype(np.float64) - cx) / fx
    yd = (xy[:, 1].astype(np.float64) - cy) / fy
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x, y = (xd - dx) / radial, (yd - dy) / radial
    return np.stack([fx * x + cx, fy * y + cy], axis=1)


class Extractor:
    """The plain extractor for one image size and ORB setting, on ``device``."""

    def __init__(self, h, w, n_features, n_levels, scale, fast_hi, fast_lo, device,
                 precision="float32", cell=16, k_per_cell=4, seed=42):
        self.h, self.w, self.device = h, w, torch.device(device)
        self.work = {"float32": torch.float32, "bfloat16": torch.bfloat16}[precision]
        sizes = level_sizes(h, w, n_levels, scale)
        self.budgets = features_per_level(n_features, n_levels, scale)
        self.L, self.fast_hi, self.fast_lo = n_levels, fast_hi, fast_lo
        self.cell, self.k = cell, k_per_cell
        dev = self.device
        Ry = np.stack([_resize_matrix(h, hl, h) for hl, _ in sizes])
        Rx = np.stack([_resize_matrix(w, wl, w) for _, wl in sizes])
        self.Ry = _bf16(torch.as_tensor(Ry[1:], device=dev))
        self.Rx = _bf16(torch.as_tensor(Rx[1:], device=dev))
        self.hb = torch.tensor([s[0] for s in sizes], device=dev)
        self.wb = torch.tensor([s[1] for s in sizes], device=dev)
        wx, wy = _ic_weights()
        self.wx = torch.as_tensor(wx.reshape(-1), device=dev)
        self.wy = torch.as_tensor(wy.reshape(-1), device=dev)
        self.table = torch.as_tensor(_brief_table(seed), device=dev).long()
        self.octave = torch.cat([torch.full((b,), l, dtype=torch.int32, device=dev)
                                 for l, b in enumerate(self.budgets)])
        self.scale = torch.cat([torch.full((b,), scale**l, dtype=torch.float32, device=dev)
                                for l, b in enumerate(self.budgets)])
        ys = torch.arange(h, device=dev)[None, :, None]
        xs = torch.arange(w, device=dev)[None, None, :]
        self.interior = ((ys >= BORDER) & (ys < self.hb[:, None, None] - BORDER)
                         & (xs >= BORDER) & (xs < self.wb[:, None, None] - BORDER))

    @torch.no_grad()
    def __call__(self, img: np.ndarray) -> dict:
        """Features of one [h, w] uint8 image: xy (distorted, level-0 pixels),
        angle, octave, desc [N, 8] uint32, valid; numpy arrays."""
        dev, work = self.device, self.work
        img = torch.as_tensor(np.asarray(img), device=dev).to(torch.float32)
        t = torch.einsum("lhy,yx->lhx", self.Ry, _bf16(img))
        rest = torch.einsum("lhx,lwx->lhw", _bf16(t), self.Rx).to(work).to(torch.float32)
        pyr = torch.cat([img[None], rest], dim=0)
        scores = _fast_scores(pyr, self.fast_hi, self.fast_lo, self.hb, self.wb)
        scores = torch.where(self.interior, scores, torch.zeros_like(scores))
        xy, valid = _cell_topk(scores, self.cell, self.k, max(self.budgets))
        xy = torch.cat([xy[l, :b] for l, b in enumerate(self.budgets)])
        valid = torch.cat([valid[l, :b] for l, b in enumerate(self.budgets)])
        L, H, W = pyr.shape
        ys = torch.minimum(torch.arange(H, device=dev)[None, :], self.hb[:, None] - 1)
        edged = torch.gather(pyr, 1, ys[:, :, None].expand(L, H, W))
        xs = torch.minimum(torch.arange(W, device=dev)[None, :], self.wb[:, None] - 1)
        edged = torch.gather(edged, 2, xs[:, None, :].expand(L, H, W))
        blurred = _blur(edged, work)
        lvl = self.octave.long()
        y0 = torch.clamp(torch.round(xy[:, 1]).long() - HALF, 0, H - PS)
        x0 = torch.clamp(torch.round(xy[:, 0]).long() - HALF, 0, W - PS)
        r = torch.arange(PS, device=dev)
        patches = blurred[lvl[:, None, None], (y0[:, None] + r)[:, :, None],
                          (x0[:, None] + r)[:, None, :]].reshape(-1, PS * PS)
        pw = patches.to(work)
        angle = torch.atan2((pw @ self.wy.to(work)).float(), (pw @ self.wx.to(work)).float())
        two_pi = 2.0 * math.pi
        a = torch.fmod(angle, two_pi)
        a = torch.where((a != 0) & ((a < 0) != (two_pi < 0)), a + two_pi, a)
        abin = torch.remainder(torch.round(a * (N_ORIENT / two_pi)).to(torch.int32), N_ORIENT)
        samples = _bf16(torch.gather(patches, 1, self.table[abin.long()]))
        samples = samples.reshape(-1, BITS, 2)
        return dict(xy=(xy * self.scale[:, None]).cpu().numpy(), angle=angle.cpu().numpy(),
                    octave=self.octave.cpu().numpy(), desc=_pack(samples[..., 0] < samples[..., 1]),
                    valid=valid.cpu().numpy())


@functools.lru_cache(maxsize=4)
def extractor(h, w, n_features, n_levels, scale, fast_hi, fast_lo, device, precision="float32"):
    return Extractor(h, w, n_features, n_levels, scale, fast_hi, fast_lo, device, precision)
