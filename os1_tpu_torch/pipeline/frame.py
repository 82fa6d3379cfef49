"""Frame construction: image -> features + undistorted coordinates.
Port of os1_tpu/pipeline/frame.py (reference Frame.cc:60-112).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..features.orb import FrameFeatures, OrbConfig, make_extractor
from ..geometry import camera as cam_mod


class FrameData(NamedTuple):
    feats: FrameFeatures  # raw pixel coords (reference mvKeys)
    xy_un: torch.Tensor  # [N, 2] undistorted coords (reference mvKeysUn)
    sigma2: torch.Tensor  # [N] per-feature squared octave scale
    # Everything keyframe insertion needs in ONE [N, 13] float32 tensor:
    # xy_un | angle | octave | valid | desc bits x8 (the reference's layout).
    host_pack: torch.Tensor = None


def unpack_host(pack: np.ndarray):
    """Host-side split of FrameData.host_pack -> (xy_un, angle, octave, desc
    uint32, valid)."""
    pack = np.ascontiguousarray(pack)
    xy_un = pack[:, :2]
    angle = pack[:, 2]
    octave = pack[:, 3].astype(np.int32)
    valid = pack[:, 4] > 0.5
    desc = np.ascontiguousarray(pack[:, 5:13]).view(np.uint32)
    return xy_un, angle, octave, desc, valid


def pack_host(feats: FrameFeatures, xy_un: torch.Tensor) -> torch.Tensor:
    return torch.cat([
        xy_un,
        feats.angle[:, None],
        feats.octave.to(torch.float32)[:, None],
        feats.valid.to(torch.float32)[:, None],
        feats.desc.view(torch.float32),
    ], dim=1)


@functools.lru_cache(maxsize=8)
def make_frame_builder(orb_cfg: OrbConfig, device: str | torch.device = "cuda"):
    device = torch.device(device)
    extractor = make_extractor(orb_cfg, device)
    sigma2_table = torch.tensor(orb_cfg.sigma2, dtype=torch.float32, device=device)

    def build(img: torch.Tensor, cam: cam_mod.Camera) -> FrameData:
        feats = extractor(img)
        xy_un = cam_mod.undistort_pixels(cam, feats.xy)
        sigma2 = sigma2_table[feats.octave.long()]
        return FrameData(feats=feats, xy_un=xy_un, sigma2=sigma2,
                         host_pack=pack_host(feats, xy_un))

    return build
