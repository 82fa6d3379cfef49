"""State carried across from the JAX package (the port has no weights: its
state is calibration, extractor tables, frames, the map, the place-recognition
databases, host and sharded, and the loop closer's memory).

Each function takes plain numpy arrays, or any object whose fields convert
with ``np.asarray`` (such as the reference package's NamedTuples and
dataclasses), so this module imports neither JAX nor ``os1_tpu``. Tensors go
to ``device``; ``None`` means the package's default, the card.
"""
from __future__ import annotations

import numpy as np
import torch

from . import default_device
from .features.orb import FrameFeatures, OrbConfig
from .geometry.camera import Camera
from .map.mirror import to_device
from .map.store import MapConfig, MapStore
from .parallel.dist_database import DistKeyFrameDatabase
from .pipeline.frame import FrameData, pack_host
from .vocab.database import KeyFrameDatabase, SparseBow


def _device(device) -> torch.device:
    return torch.device(device) if device is not None else default_device()


def camera_from_numpy(cam, device=None) -> Camera:
    """Port Camera from a camera with fields fx, fy, cx, cy, dist [8],
    fisheye, width, height."""
    device = _device(device)
    f = {k: np.asarray(getattr(cam, k)) for k in Camera._fields}
    return Camera.make(float(f["fx"]), float(f["fy"]), float(f["cx"]), float(f["cy"]),
                       dist=f["dist"].astype(np.float32), fisheye=bool(f["fisheye"]),
                       width=float(f["width"]), height=float(f["height"]), device=device)


def orb_config_from_fields(cfg) -> OrbConfig:
    """Port OrbConfig from an extractor config with the same field names."""
    return OrbConfig(**{k: getattr(cfg, k) for k in OrbConfig._fields})


def frame_from_numpy(xy, response, angle, octave, desc, valid, xy_un, sigma2,
                     device=None) -> FrameData:
    """Port FrameData from a frame's arrays (desc uint32 [N, 8])."""
    device = _device(device)
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
        if isinstance(val, np.ndarray) and name != "pt_gen":  # the port's own, kept at 0
            setattr(st, name, np.array(getattr(src, name), dtype=val.dtype, copy=True))
    st._kf_seq_next = int(getattr(src, "_kf_seq_next", 0))
    st._pt_cursor = int(getattr(src, "_pt_cursor", 0))
    st.culled_links = {k: (p, s, np.array(T, np.float32, copy=True))
                       for k, (p, s, T) in getattr(src, "culled_links", {}).items()}
    return st


def to_torch(a, device=None) -> torch.Tensor:
    """Any numpy-convertible array -> torch on ``device`` (uint32 -> int32 bits)."""
    return to_device(np.asarray(a), _device(device))


def database_from_numpy(src, vocab) -> KeyFrameDatabase:
    """Port KeyFrameDatabase over ``vocab`` holding the per-keyframe BoW
    vectors of a database with the reference's fields (``bows``: per slot
    None or (words, weights); ``active``)."""
    db = KeyFrameDatabase(vocab, len(src.bows))
    for kf, bow in enumerate(src.bows):
        if bow is not None and bool(np.asarray(src.active)[kf]):
            db.add(kf, SparseBow(words=np.array(bow[0], np.int32),
                                 weights=np.array(bow[1], np.float32)))
    return db


def copy_loop_state(src, dst) -> None:
    """Carry a loop closer's memory (``loop_edges``, ``consistent_groups``,
    ``last_loop_kf``, ``n_loops_closed``) onto the port's LoopCloser ``dst``."""
    dst.loop_edges = [(int(a), int(b)) for a, b in src.loop_edges]
    dst.consistent_groups = [({int(k) for k in g}, int(c)) for g, c in src.consistent_groups]
    dst.last_loop_kf = int(src.last_loop_kf)
    dst.n_loops_closed = int(src.n_loops_closed)


def dist_database_from_numpy(src, mesh):
    """Port DistKeyFrameDatabase over the port's ``mesh`` holding the padded
    rows of a sharded database with the reference's fields (``words``,
    ``weights``, ``active``, ``max_keyframes``)."""
    db = DistKeyFrameDatabase(mesh, int(src.max_keyframes))
    db.words[:] = np.asarray(src.words, np.int32)
    db.weights[:] = np.asarray(src.weights, np.float32)
    db.active[:] = np.asarray(src.active, bool)
    return db
