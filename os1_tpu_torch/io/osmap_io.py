"""Osmap map persistence. Port of os1_tpu/io/osmap_io.py (reference
Osmap.cpp:68-291): a YAML header and the ``.mappoints``, ``.keyframes`` and
``.features`` protocol-buffers files, then the rebuild of every derived
state on load (Osmap::rebuild, Osmap.cpp:507-660).

The files are the reference package's byte for byte: the header goes through
``filestorage`` and the messages through ``osmap_wire``, both written by hand,
so nothing here needs protobuf, PyYAML or OpenCV. Poses are the first 12
floats of Tcw, and the features file is one message or varint-delimited
messages, one keyframe each (Osmap.cpp:356-434). Host numpy throughout: the
store lives on the host, and the system republishes its device mirror after a
load.
"""
from __future__ import annotations

import numpy as np

from . import filestorage
from .osmap_wire import DecodeError, decode, encode, read_varint, varint

# Option bits (reference Osmap.h:189-213).
NO_LOOPS = 1 << 0
NO_FEATURES_DESCRIPTORS = 1 << 1
K_IN_KEYFRAME = 1 << 2
ONLY_MAPPOINTS_FEATURES = 1 << 3
FEATURES_FILE_DELIMITED = 1 << 4
FEATURES_FILE_NOT_DELIMITED = 1 << 5

FEATURES_MESSAGE_LIMIT = 1_000_000
_FEATURES = "SerializedKeyframeFeaturesArray"


def _base(base: str) -> str:
    return base[:-5] if base.endswith(".yaml") else base


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _features_message(store, k: int, only_mp: bool, no_desc: bool) -> tuple[dict, int]:
    """One keyframe's SerializedKeyframeFeatures and its feature count."""
    feats = []
    xy, angle, octave = store.kf_xy[k].tolist(), store.kf_angle[k].tolist(), store.kf_octave[k]
    obs, desc = store.kf_obs_point[k].tolist(), store.kf_desc[k].tolist()
    for i in np.nonzero(store.kf_feat_valid[k])[0].tolist():
        pid = obs[i]
        if only_mp and pid < 0:
            continue
        feat = {"keypoint": {"ptx": xy[i][0], "pty": xy[i][1], "angle": angle[i],
                             "octave": float(octave[i])}}
        if pid >= 0:
            feat["mappoint_id"] = pid + 1  # 0 = "no mappoint" on the wire
        if not no_desc:
            feat["briefdescriptor"] = {"block": desc[i]}
        feats.append(feat)
    return {"keyframe_id": int(k), "feature": feats}, len(feats)


def save_map(store, cfg, base: str, options: int = 0) -> dict:
    """Write the live map to ``base``.yaml/.mappoints/.keyframes/.features.
    Returns the header dict. Dead slots are skipped, the equivalent of the
    reference's depuration before a save (Osmap.cpp:481-505)."""
    base = _base(base)
    header: dict = {"Options": options}

    pts = np.nonzero(store.pt_valid)[0]
    mappoints = [{"id": int(p), "position": dict(zip("xyz", map(float, store.pt_xyz[p]))),
                  "visible": float(store.pt_visible[p]), "found": float(store.pt_found[p]),
                  "briefdescriptor": {"block": store.pt_desc[p].tolist()}} for p in pts]
    with open(base + ".mappoints", "wb") as f:
        f.write(encode("SerializedMappointArray", {"mappoint": mappoints}))
    header["mappointsFile"] = base + ".mappoints"
    header["nMappoints"] = len(pts)

    kfs = np.nonzero(store.kf_valid)[0]
    keyframes = [{"id": int(k), "pose": {"element": store.kf_T[k][:3].reshape(-1).tolist()},
                  "timestamp": float(store.kf_timestamp[k])} for k in kfs]
    with open(base + ".keyframes", "wb") as f:
        f.write(encode("SerializedKeyframeArray", {"keyframe": keyframes}))
    header["keyframesFile"] = base + ".keyframes"
    header["nKeyframes"] = len(kfs)

    only_mp = bool(options & ONLY_MAPPOINTS_FEATURES)
    no_desc = bool(options & NO_FEATURES_DESCRIPTORS)
    per_kf = [_features_message(store, k, only_mp, no_desc) for k in kfs]
    n_features = sum(n for _, n in per_kf)
    delimited = bool(options & FEATURES_FILE_DELIMITED) or (
        not options & FEATURES_FILE_NOT_DELIMITED and n_features > FEATURES_MESSAGE_LIMIT)
    with open(base + ".features", "wb") as f:
        if delimited:
            for msg, _ in per_kf:
                data = encode(_FEATURES, {"feature": [msg]})
                f.write(varint(len(data)) + data)
        else:
            f.write(encode(_FEATURES, {"feature": [msg for msg, _ in per_kf]}))
    header["featuresFile"] = base + ".features"
    header["nFeatures"] = n_features

    header["cameraMatrices"] = [dict(zip(filestorage.K_KEYS, map(float, cfg.intr[:4])))]
    header["loopEdges"] = []
    filestorage.write_header(base + ".yaml", header)
    return header


def read_features(raw: bytes, max_keyframes: int) -> list[dict]:
    """The SerializedKeyframeFeatures entries of a ``.features`` file, in
    either layout. The layout rule is the reference's: the file is one
    message if it parses as one and every ``keyframe_id`` is a slot of this
    store (and it is not an empty parse of a non-empty file); otherwise it
    is varint-delimited."""
    try:
        entries = decode(_FEATURES, raw).get("feature", [])
        ok = all(e.get("keyframe_id", 0) < max_keyframes for e in entries)
    except DecodeError:
        ok = False
    if ok and (entries or not raw):
        return entries
    entries, pos = [], 0
    while pos < len(raw):
        n, pos = read_varint(raw, pos)
        entries += decode(_FEATURES, raw[pos:pos + n]).get("feature", [])
        pos += n
    return entries


def _fill_features(store, k: int, feats: list) -> list:
    """Write one keyframe's wire features into its slot; returns the
    (feature index, wire mappoint id) of each feature, in order."""
    feats = feats[:store.cfg.n_features]
    bound = []
    for i, feat in enumerate(feats):
        kp = feat.get("keypoint", {})
        store.kf_feat_valid[k, i] = True
        store.kf_xy[k, i] = (kp.get("ptx", 0.0), kp.get("pty", 0.0))
        store.kf_angle[k, i] = kp.get("angle", 0.0)
        store.kf_octave[k, i] = int(kp.get("octave", 0.0))
        block = feat.get("briefdescriptor", {}).get("block", ())
        if len(block) == 8:
            store.kf_desc[k, i] = block
        bound.append((i, feat.get("mappoint_id", 0) - 1))
    return bound


def _read_files(base: str):
    base = _base(base)
    header = filestorage.read_header(base + ".yaml")
    keyframes = decode("SerializedKeyframeArray",
                       _read(header.get("keyframesFile", base + ".keyframes"))).get("keyframe", [])
    mappoints = decode("SerializedMappointArray",
                       _read(header.get("mappointsFile", base + ".mappoints"))).get("mappoint", [])
    raw = _read(header.get("featuresFile", base + ".features"))
    return header, keyframes, mappoints, raw


def _pose(kf_msg: dict) -> np.ndarray:
    T = np.eye(4, dtype=np.float32)
    T[:3] = np.array(kf_msg.get("pose", {}).get("element", []), np.float32).reshape(3, 4)
    return T


def _point(store, p: int, m: dict) -> None:
    pos = m.get("position", {})
    store.pt_xyz[p] = [pos.get("x", 0.0), pos.get("y", 0.0), pos.get("z", 0.0)]
    store.pt_visible[p] = int(m.get("visible", 0.0))
    store.pt_found[p] = int(m.get("found", 0.0))
    block = m.get("briefdescriptor", {}).get("block", ())
    if len(block) == 8:
        store.pt_desc[p] = block


def load_map(store, cfg, base: str) -> dict:
    """Load a map written by :func:`save_map`, by the reference package or by
    os1 into a cleared store, then rebuild the derived state. Returns the
    header dict."""
    header, keyframes, mappoints, raw = _read_files(base)
    store.__post_init__()  # clear

    for m in keyframes:
        k = m.get("id", 0)
        store.kf_valid[k] = True
        store.kf_T[k] = _pose(m)
        store.kf_timestamp[k] = m.get("timestamp", 0.0)
        # Saved ids are age-ordered within the saving session, and the wire
        # format has no frame ids: the slot id seeds the age bookkeeping.
        store.kf_frame_id[k] = k
        store.kf_seq[k] = k
    if keyframes:
        store._kf_seq_next = max(m.get("id", 0) for m in keyframes) + 1

    for m in mappoints:
        p = m.get("id", 0)
        store.pt_valid[p] = True
        # Loaded points are mature: never "recent" for the found/visible cull.
        store.pt_first_seq[p] = -(10**9)
        _point(store, p, m)

    for entry in read_features(raw, store.cfg.max_keyframes):
        k = entry.get("keyframe_id", 0)
        for i, pid in _fill_features(store, k, entry.get("feature", [])):
            if pid >= 0 and store.pt_valid[pid]:
                store.add_observation(pid, k, i)

    rebuild(store, cfg)
    return header


def merge_map(store, cfg, base: str):
    """Load another session's map into the free slots of a live store, ids
    remapped: the substrate of a multi-session merge (the reference's mapLoad
    replaces the map, Osmap.cpp:180-291; a merge needs both resident). The
    loaded geometry stays in its own session's world frame; the caller aligns
    and fuses it (System.merge_session).

    Returns (kf_map, pt_map): old id -> new slot (-1: not loaded)."""
    header, keyframes, mappoints, raw = _read_files(base)

    kf_map = np.full(store.cfg.max_keyframes, -1, np.int64)
    # Age-ordered insertion: the merged keyframes continue this store's
    # monotonic sequence after the resident ones.
    fid_base = int(store.kf_frame_id[store.kf_valid].max(initial=-1)) + 1
    for m in sorted(keyframes, key=lambda m: m.get("id", 0)):
        old = m.get("id", 0)
        kf_map[old] = store.add_keyframe_pending(_pose(m), frame_id=fid_base + old,
                                                 timestamp=m.get("timestamp", 0.0))

    pt_map = np.full(store.cfg.max_points, -1, np.int64)
    ids = store.alloc_points(len(mappoints))
    # Merged points survived their session's culling: mature by definition.
    store.pt_first_seq[ids] = -(10**9)
    for p, m in zip(ids, mappoints):
        pt_map[m.get("id", 0)] = p
        _point(store, p, m)

    for entry in read_features(raw, store.cfg.max_keyframes):
        k = int(kf_map[entry.get("keyframe_id", 0)])
        if k < 0:
            continue
        for i, pid_old in _fill_features(store, k, entry.get("feature", [])):
            if pid_old >= 0 and pt_map[pid_old] >= 0:
                store.add_observation(int(pt_map[pid_old]), k, i)

    # Merged points that arrived with no observation are culled; the rest
    # get their derived state (normal, scale band, distinctive descriptor).
    merged = pt_map[pt_map >= 0]
    orphans = merged[store.pt_n_obs[merged] == 0]
    if len(orphans):
        store.cull_points(orphans)
    merged = merged[store.pt_valid[merged]]
    store.update_point_derived(merged, cfg.orb.scale_factor, cfg.orb.n_levels)
    return kf_map, pt_map


def rebuild(store, cfg) -> None:
    """Recompute the derived state after a load (Osmap::rebuild,
    Osmap.cpp:507-660): points with no observation are culled, the rest get
    their normal, scale band and distinctive descriptor. Covisibility is
    computed on demand, so nothing else is stored."""
    pts = np.nonzero(store.pt_valid)[0]
    orphans = pts[store.pt_n_obs[pts] == 0]
    if len(orphans):
        store.cull_points(orphans)
    pts = np.nonzero(store.pt_valid)[0]
    store.update_point_derived(pts, cfg.orb.scale_factor, cfg.orb.n_levels)
