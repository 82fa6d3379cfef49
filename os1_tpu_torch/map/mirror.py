"""Device-resident mirror of the map store. Port of os1_tpu/map/mirror.py.

The host :class:`~os1_tpu_torch.map.store.MapStore` owns all bookkeeping in
numpy; per-frame device work reads this mirror instead of uploading map
slices every frame. Publishes are incremental: a host-side shadow of the
dynamic state is diffed against the store and only the changed point and
keyframe rows are written into the device tensors with ``index_copy_``
(the reference's diff-and-scatter publish). Descriptors are viewed as int32.
"""
from __future__ import annotations

import numpy as np
import torch

from .store import MapStore

# Dynamic point-block fields mirrored with row-diff updates.
_PT_FIELDS = (
    "pt_xyz", "pt_desc", "pt_valid", "pt_normal", "pt_min_dist",
    "pt_max_dist", "pt_n_obs", "pt_obs_kf", "pt_obs_feat",
)
_KF_STATIC = ("kf_xy", "kf_angle", "kf_octave", "kf_desc")
_KF_ROWS = ("kf_feat_valid", "kf_obs_point")


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """numpy -> torch on ``device``; uint32 arrives as int32 with the same bits."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # torch.from_numpy wants writable memory
        a = a.copy()
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def _row_changed(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[n] bool: any element differs in row i."""
    d = a != b
    return d.reshape(len(d), -1).any(axis=1) if d.ndim > 1 else d


class DeviceMirror:
    """Point block, keyframe block and their host shadow."""

    def __init__(self, store: MapStore, device: str | torch.device = "cuda"):
        self.store = store
        self.device = torch.device(device)
        self.version = 0
        self.refresh()

    def _publish(self, name: str) -> None:
        setattr(self, name, to_device(getattr(self.store, name), self.device))

    def refresh(self) -> None:
        """Full re-publish of every mirrored array from the host store."""
        st = self.store
        for f in _PT_FIELDS + ("kf_T", "kf_valid") + _KF_STATIC + _KF_ROWS:
            self._publish(f)
        self._shadow = {f: getattr(st, f).copy() for f in _PT_FIELDS + _KF_ROWS}
        self.version += 1

    def _scatter_rows(self, fields, idx: np.ndarray) -> None:
        st = self.store
        didx = torch.from_numpy(idx.astype(np.int64)).to(self.device)
        for f in fields:
            getattr(self, f).index_copy_(0, didx, to_device(getattr(st, f)[idx], self.device))
            self._shadow[f][idx] = getattr(st, f)[idx]

    def refresh_dynamic(self) -> None:
        """Incremental publish: scatter changed point rows and keyframe
        binding rows; re-upload the small pose and liveness arrays whole."""
        st = self.store
        sh = self._shadow
        changed = np.zeros(st.cfg.max_points, bool)
        for f in _PT_FIELDS:
            changed |= _row_changed(getattr(st, f), sh[f])
        idx = np.nonzero(changed)[0]
        if len(idx) > st.cfg.max_points // 4:
            for f in _PT_FIELDS:  # bulk change: wholesale is cheaper
                self._publish(f)
                sh[f] = getattr(st, f).copy()
        elif len(idx):
            self._scatter_rows(_PT_FIELDS, idx)

        self._publish("kf_T")
        self._publish("kf_valid")
        K = st.cfg.max_keyframes
        for f in _KF_ROWS:
            kidx = np.nonzero(_row_changed(getattr(st, f), sh[f]))[0]
            if len(kidx) > K // 4:
                self._publish(f)
                sh[f] = getattr(st, f).copy()
            elif len(kidx):
                self._scatter_rows((f,), kidx)
        self.version += 1

    def insert_keyframe_row(self, k: int) -> None:
        """Publish one keyframe's static feature arrays (row k)."""
        for f in _KF_STATIC:
            getattr(self, f)[k] = to_device(getattr(self.store, f)[k], self.device)
