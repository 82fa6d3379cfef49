"""State carried across from the JAX package (the port has no weights: its
state is calibration, extractor tables, frames and the map).

Each function takes plain numpy arrays, or any object whose fields convert
with ``np.asarray`` (such as the reference package's NamedTuples and
dataclasses), so this module imports neither JAX nor ``os1_tpu``.
"""
from __future__ import annotations

import numpy as np
import torch

from .features.orb import FrameFeatures, OrbConfig
from .geometry.camera import Camera
from .map.mirror import to_device
from .map.store import MapConfig, MapStore
from .pipeline.frame import FrameData, pack_host


def camera_from_numpy(cam, device="cpu") -> Camera:
    """Port Camera from a camera with fields fx, fy, cx, cy, dist [8],
    fisheye, width, height."""
    f = {k: np.asarray(getattr(cam, k)) for k in Camera._fields}
    return Camera.make(float(f["fx"]), float(f["fy"]), float(f["cx"]), float(f["cy"]),
                       dist=f["dist"].astype(np.float32), fisheye=bool(f["fisheye"]),
                       width=float(f["width"]), height=float(f["height"]), device=device)


def orb_config_from_fields(cfg) -> OrbConfig:
    """Port OrbConfig from an extractor config with the same field names."""
    return OrbConfig(**{k: getattr(cfg, k) for k in OrbConfig._fields})


def frame_from_numpy(xy, response, angle, octave, desc, valid, xy_un, sigma2,
                     device="cpu") -> FrameData:
    """Port FrameData from a frame's arrays (desc uint32 [N, 8])."""
    d = lambda a: to_device(np.asarray(a), device)  # noqa: E731
    feats = FrameFeatures(xy=d(xy), response=d(response), angle=d(angle),
                          octave=d(np.asarray(octave, np.int32)),
                          desc=d(np.asarray(desc, np.uint32)), valid=d(np.asarray(valid, bool)))
    xy_un_t = d(xy_un)
    return FrameData(feats=feats, xy_un=xy_un_t, sigma2=d(sigma2),
                     host_pack=pack_host(feats, xy_un_t))


def store_from_numpy(src) -> MapStore:
    """Port MapStore holding copies of every array of a map store with the
    reference's fields (so both trackers can be handed the same map)."""
    cfg = MapConfig(**{k: getattr(src.cfg, k) for k in
                       ("max_keyframes", "max_points", "n_features", "max_obs_per_point")})
    st = MapStore(cfg)
    for name, val in vars(st).items():
        if isinstance(val, np.ndarray):
            setattr(st, name, np.array(getattr(src, name), dtype=val.dtype, copy=True))
    st._kf_seq_next = int(getattr(src, "_kf_seq_next", 0))
    st._pt_cursor = int(getattr(src, "_pt_cursor", 0))
    st.culled_links = {k: (p, s, np.array(T, np.float32, copy=True))
                       for k, (p, s, T) in getattr(src, "culled_links", {}).items()}
    return st


def to_torch(a, device="cpu") -> torch.Tensor:
    """Any numpy-convertible array -> torch on ``device`` (uint32 -> int32 bits)."""
    return to_device(np.asarray(a), device)
