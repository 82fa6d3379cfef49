"""Osmap persistence of the port (os1_tpu_torch.io: osmap_wire, filestorage,
osmap_io; System.save_map / load_map) against the JAX package's, on the CPU
at 240x320, 512 features, 4 levels, MapConfig(64, 8192, 512): the map of a
30-frame port session over orbit_trajectory(30, advance=0.08) of
default_scene(seed=3), the JAX package's own Osmap test sequence.

- Files: a JAX-package MapStore filled from the port's store field by field
  and saved by the JAX package's ``save_map`` gives ``.mappoints``,
  ``.keyframes`` and ``.features`` byte-identical to the port's, under the
  options 0, FEATURES_FILE_DELIMITED, ONLY_MAPPOINTS_FEATURES and
  NO_FEATURES_DESCRIPTORS; the headers are equal after their directive line
  and return the same dict. Each package loads the other's files to stores
  whose every array is equal exactly (``pt_desc`` after the rebuild
  included), and equal to what it loads from its own.
- The wire codec on messages that protobuf (``osmap_pb2``) builds, by
  hypothesis: decode equals ``ParseFromString`` and encode equals
  ``SerializeToString``, with zero and -0.0 fields, empty sub-messages,
  features with no keypoint and floats beyond float32's range; an unpacked
  repeated field, fields in reverse order, a sub-message given twice, the
  C++ writer's ``kmatrix`` (3) and ``loopedgesids`` (5) and fields unknown to
  the schema of every wire type are read as protobuf reads them; corrupted
  bytes are refused exactly where protobuf refuses them; a features file's
  layout is decided as the JAX package decides it, delimited files whose
  bytes also parse as one message included.
- The header: OpenCV reads the port's header to the same values, and the
  port reads the headers OpenCV and ``yaml.safe_dump`` write.
- Load and resume: after ``load_map`` the port is LOST, and frame 12
  relocalizes within 0.05 rad and 0.2 units of the pose the session recorded
  for it (read from the 6-tuple ``tracker.trajectory``).
- ``System.load_map`` against the JAX package's on the same files: the
  stores, the database's BoW vectors, the state and the reference keyframe.
- The shipped mode (pipelined, cooperative mapping, loop closing) saved
  while a keyframe still waits for its feature arrays: the save drains the
  scheduler first, so every saved keyframe carries its features.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as hs

from os1_tpu_torch.features.orb import OrbConfig
from os1_tpu_torch.geometry.camera import Camera
from os1_tpu_torch.io import filestorage, osmap_io, osmap_wire, synthetic
from os1_tpu_torch.map.store import MapConfig, MapStore
from os1_tpu_torch.pipeline import SlamConfig, System, TrackingState

H, W = 240, 320
K = np.array([[260.0, 0, 160.0], [0, 260.0, 120.0], [0, 0, 1.0]])
OPTIONS = (0, osmap_io.FEATURES_FILE_DELIMITED, osmap_io.ONLY_MAPPOINTS_FEATURES,
           osmap_io.NO_FEATURES_DESCRIPTORS)
PARTS = (".mappoints", ".keyframes", ".features")


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def config():
    return SlamConfig(camera=Camera.make(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=W, height=H),
                      orb=OrbConfig(height=H, width=W, n_features=512, n_levels=4),
                      map=MapConfig(max_keyframes=64, max_points=8192, n_features=512))


@pytest.fixture(scope="module")
def frames():
    poses = synthetic.orbit_trajectory(30, advance=0.08)
    return synthetic.render_sequence(synthetic.default_scene(seed=3), poses, K, H, W)


@pytest.fixture(scope="module")
def mapped(frames):
    sys_ = System(config(), device="cpu")
    for i, f in enumerate(frames):
        sys_.track_monocular(f, timestamp=i / 30.0)
    assert sys_.state == TrackingState.OK
    return sys_


@pytest.fixture(scope="module")
def jax_io():
    pytest.importorskip("google.protobuf")
    pytest.importorskip("jax")
    from os1_tpu.io import osmap_io as jio
    from os1_tpu.io import osmap_pb2
    from os1_tpu.map.store import MapConfig as JMapConfig
    from os1_tpu.map.store import MapStore as JMapStore

    return jio, osmap_pb2, JMapConfig, JMapStore


def store_arrays(st) -> dict:
    out = {f.name: getattr(st, f.name) for f in dataclasses.fields(st) if f.name != "cfg"}
    out["_kf_seq_next"] = st._kf_seq_next
    return out


def assert_stores_equal(a, b):
    sa, sb = store_arrays(a), store_arrays(b)
    assert sa.keys() == sb.keys()
    for name in sa:
        np.testing.assert_array_equal(np.asarray(sa[name]), np.asarray(sb[name]), err_msg=name)


def jax_store_from(st, jax_io):
    """A JAX-package MapStore holding the port store's map, field by field."""
    _, _, JMapConfig, JMapStore = jax_io
    js = JMapStore(JMapConfig(**dataclasses.asdict(st.cfg)))
    for name, value in store_arrays(st).items():
        setattr(js, name, value.copy() if isinstance(value, np.ndarray) else value)
    return js


# --------------------------------------------------------------------- #
# files, both ways
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("options", OPTIONS)
def test_files_equal_the_jax_package_and_load_both_ways(mapped, jax_io, tmp_path, options):
    jio, _, JMapConfig, JMapStore = jax_io
    st, cfg = mapped.store, mapped.cfg
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    h_port = mapped.save_map(port, options)
    h_ref = jio.save_map(jax_store_from(st, jax_io), cfg, ref, options)
    assert h_port["nKeyframes"] == st.n_keyframes() and h_port["nMappoints"] == st.n_points()
    assert h_port == {k: (v.replace(ref, port) if isinstance(v, str) else v)
                      for k, v in h_ref.items()}
    for part in PARTS:
        with open(port + part, "rb") as f, open(ref + part, "rb") as g:
            assert f.read() == g.read(), part
    with open(port + ".yaml") as f, open(ref + ".yaml") as g:
        assert f.read().split("\n", 1)[1] == g.read().split("\n", 1)[1].replace(ref, port)

    loaded = {}
    for who, base in (("port", port), ("ref", ref)):
        ps = MapStore(st.cfg)
        osmap_io.load_map(ps, cfg, base)
        js = JMapStore(JMapConfig(**dataclasses.asdict(st.cfg)))
        jio.load_map(js, cfg, base)
        assert_stores_equal(ps, js)
        loaded[who] = ps
    assert_stores_equal(loaded["port"], loaded["ref"])
    ps = loaded["port"]
    live = np.nonzero(st.kf_valid)[0]
    np.testing.assert_array_equal(ps.kf_valid, st.kf_valid)
    np.testing.assert_array_equal(ps.kf_T[live], st.kf_T[live])
    pts = np.nonzero(ps.pt_valid)[0]
    np.testing.assert_array_equal(ps.pt_xyz[pts], st.pt_xyz[pts])
    if options & osmap_io.ONLY_MAPPOINTS_FEATURES:
        assert ps.kf_feat_valid.sum() < st.kf_feat_valid.sum()
    else:
        np.testing.assert_array_equal(ps.kf_obs_point[live], st.kf_obs_point[live])
        np.testing.assert_array_equal(ps.kf_xy[live], st.kf_xy[live])
        if not options & osmap_io.NO_FEATURES_DESCRIPTORS:
            np.testing.assert_array_equal(ps.kf_desc[live], st.kf_desc[live])


# --------------------------------------------------------------------- #
# the wire codec against protobuf
# --------------------------------------------------------------------- #
def pb_dict(m) -> dict:
    """A protobuf message as the codec's dict (set fields only)."""
    out = {}
    for fd, v in m.ListFields():
        rep = fd.is_repeated
        if fd.message_type is not None:
            out[fd.name] = [pb_dict(x) for x in v] if rep else pb_dict(v)
        else:
            out[fd.name] = list(v) if rep else v
    return out


def same(a, b) -> bool:
    """Equal, floats by their bits (NaN equal to NaN)."""
    if isinstance(a, float) and isinstance(b, float):
        return np.float64(a).tobytes() == np.float64(b).tobytes() or (a != a and b != b)
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(map(same, a, b))
    return type(a) is type(b) and a == b


FLOATS = hs.one_of(hs.sampled_from([0.0, -0.0, 1.0, -1.0, 1e-46, -1e-46, 3.5e38, -1e39,
                                    float("inf"), float("nan")]),
                   hs.floats(allow_nan=False, width=32), hs.floats(allow_nan=False))
UINTS = hs.one_of(hs.sampled_from([0, 1, 127, 128, 2**32 - 1]), hs.integers(0, 2**32 - 1))


@hs.composite
def pb_message(draw, pb, name, depth=0):
    """A protobuf message of type ``name``: each field unset, set (zero
    included) or, for a sub-message, present and empty."""
    m = getattr(pb, name)()
    for num, (field, kind, repeated) in osmap_wire.SCHEMA[name].items():
        if not draw(hs.booleans()):
            continue
        if kind in osmap_wire.SCHEMA:
            if repeated:
                for _ in range(draw(hs.integers(0, 3 if depth < 2 else 1))):
                    getattr(m, field).add().CopyFrom(draw(pb_message(pb, kind, depth + 1)))
            else:
                sub = getattr(m, field)
                sub.SetInParent()
                sub.MergeFrom(draw(pb_message(pb, kind, depth + 1)))
        else:
            values = FLOATS if kind in (osmap_wire.FLOAT, osmap_wire.DOUBLE) else UINTS
            if repeated:
                getattr(m, field).extend(draw(hs.lists(values, max_size=12)))
            else:
                setattr(m, field, draw(values))
    return m


@settings(max_examples=300, deadline=None, derandomize=True,
          suppress_health_check=list(HealthCheck))
@given(data=hs.data())
def test_codec_equals_protobuf(jax_io, data):
    pb = jax_io[1]
    name = data.draw(hs.sampled_from(sorted(osmap_wire.SCHEMA)))
    m = data.draw(pb_message(pb, name))
    wire = m.SerializeToString()
    assert osmap_wire.encode(name, pb_dict(m)) == wire
    assert same(osmap_wire.decode(name, wire), pb_dict(m))


def _field(num, wt, payload: bytes) -> bytes:
    return osmap_wire.varint(num << 3 | wt) + payload


def _delimited(num, payload: bytes) -> bytes:
    return _field(num, 2, osmap_wire.varint(len(payload)) + payload)


def _f32(*v) -> bytes:
    return np.array(v, "<f4").tobytes()


def test_codec_reads_any_proto3_writer(jax_io):
    """Forms protobuf's own serializer never writes but a proto3 reader must
    take: each is read to what ParseFromString reads."""
    pb = jax_io[1]
    v = osmap_wire.varint
    unknown = (_field(9, 0, v(300)) + _field(10, 1, bytes(8)) + _delimited(11, b"xyz")
               + _field(12, 5, bytes(4)) + _field(13, 3, _field(1, 0, v(5)) + _field(13, 4, b"")))
    keyframe = (_field(6, 1, np.float64(2.5).tobytes())  # reverse field order
                + _delimited(5, v(3) + v(300))  # loopedgesids, packed
                + _field(5, 0, v(7))  # and unpacked
                + _delimited(3, _field(1, 5, _f32(400.0)))  # kmatrix (K_IN_KEYFRAME)
                + _delimited(2, b"".join(_field(1, 5, _f32(x)) for x in range(12)))  # unpacked pose
                + unknown + _field(1, 0, v(4)) + _field(1, 0, v(0)))  # id given twice: the last
    feature = (_delimited(3, _field(1, 5, _f32(1.0))) + _delimited(3, _field(2, 5, _f32(2.0)))
               + _field(2, 0, v(9)) + unknown)  # keypoint given twice: merged
    cases = [("SerializedKeyframeArray", _delimited(1, keyframe) + _delimited(1, b"")),
             ("SerializedKeyframeFeatures", _field(1, 0, v(2)) + _delimited(2, feature)
              + _delimited(2, b"")),
             ("SerializedDescriptor", _field(1, 5, (7).to_bytes(4, "little")) +
              _delimited(1, np.arange(3, dtype="<u4").tobytes()))]
    for name, wire in cases:
        m = getattr(pb, name)()
        m.ParseFromString(wire)
        assert same(osmap_wire.decode(name, wire), pb_dict(m)), name


@settings(max_examples=300, deadline=None, derandomize=True,
          suppress_health_check=list(HealthCheck))
@given(data=hs.data())
def test_codec_refuses_what_protobuf_refuses(jax_io, data):
    from google.protobuf.message import DecodeError

    pb = jax_io[1]
    name = data.draw(hs.sampled_from(sorted(osmap_wire.SCHEMA)))
    raw = bytearray(data.draw(pb_message(pb, name)).SerializeToString())
    for _ in range(data.draw(hs.integers(1, 3))):
        at = data.draw(hs.integers(0, len(raw)))
        op = data.draw(hs.sampled_from(["set", "cut", "put"] if at < len(raw) else ["put"]))
        if op == "set":
            raw[at] = data.draw(hs.integers(0, 255))
        elif op == "cut":
            del raw[at]
        else:
            raw.insert(at, data.draw(hs.integers(0, 255)))
    m = getattr(pb, name)()
    try:
        m.ParseFromString(bytes(raw))
    except DecodeError:
        with pytest.raises(osmap_wire.DecodeError):
            osmap_wire.decode(name, bytes(raw))
        return
    assert same(osmap_wire.decode(name, bytes(raw)), pb_dict(m))


def jax_layout(pb, raw: bytes, max_keyframes: int):
    """The JAX package's layout rule (os1_tpu/io/osmap_io.py::load_map):
    the keyframe ids it reads from a features file, or None if it raises."""
    from google.protobuf.message import DecodeError

    farr = pb.SerializedKeyframeFeaturesArray()
    try:
        farr.ParseFromString(raw)
        ok = all(kf.keyframe_id < max_keyframes for kf in farr.feature)
    except DecodeError:
        ok = False
    if ok and not (len(farr.feature) == 0 and raw):
        return [kf.keyframe_id for kf in farr.feature]
    ids, pos = [], 0
    try:
        while pos < len(raw):
            n, pos = osmap_wire.read_varint(raw, pos)
            chunk = pb.SerializedKeyframeFeaturesArray()
            chunk.ParseFromString(raw[pos:pos + n])
            pos += n
            ids += [kf.keyframe_id for kf in chunk.feature]
    except (DecodeError, osmap_wire.DecodeError):
        return None
    return ids


@settings(max_examples=200, deadline=None, derandomize=True,
          suppress_health_check=list(HealthCheck))
@given(ids=hs.lists(hs.integers(0, 300), max_size=4), n_feat=hs.lists(hs.integers(0, 3), max_size=4),
       delimited=hs.booleans(), max_keyframes=hs.sampled_from([8, 64, 256]))
def test_features_layout_is_decided_as_the_jax_package_decides(jax_io, ids, n_feat, delimited,
                                                               max_keyframes):
    pb = jax_io[1]
    entries = [{"keyframe_id": k, "feature": [{"mappoint_id": j + 1, "keypoint": {"ptx": 1.0}}
                                              for j in range(n)]}
               for k, n in zip(ids, n_feat + [1] * len(ids))]
    if delimited:
        raw = b"".join(osmap_wire.varint(len(d)) + d for d in
                       (osmap_wire.encode("SerializedKeyframeFeaturesArray", {"feature": [e]})
                        for e in entries))
    else:
        raw = osmap_wire.encode("SerializedKeyframeFeaturesArray", {"feature": entries})
    ref = jax_layout(pb, raw, max_keyframes)
    if ref is None:
        with pytest.raises(osmap_wire.DecodeError):
            osmap_io.read_features(raw, max_keyframes)
    else:
        assert [e.get("keyframe_id", 0) for e in osmap_io.read_features(raw, max_keyframes)] == ref


def test_delimited_file_that_parses_as_one_message(jax_io):
    """A delimited file of one 13-byte chunk starts with 0x0d, a fixed32
    field 1: the whole file parses as one message, with field 1 skipped as
    a field of the wrong wire type, and holds no keyframe. Both packages
    read it as delimited, by the rule for an empty parse of a non-empty
    file."""
    pb = jax_io[1]
    chunk = osmap_wire.encode("SerializedKeyframeFeaturesArray", {"feature": [
        {"keyframe_id": 5, "feature": [{"keypoint": {"ptx": 1.0}}]}]})
    raw = osmap_wire.varint(len(chunk)) + chunk
    assert raw[0] == 0x0d
    whole = pb.SerializedKeyframeFeaturesArray()
    whole.ParseFromString(raw)  # no DecodeError
    assert len(whole.feature) == 0 and osmap_wire.decode("SerializedKeyframeFeaturesArray",
                                                         raw) == {}
    for max_keyframes in (4, 64):
        got = [e.get("keyframe_id", 0) for e in osmap_io.read_features(raw, max_keyframes)]
        assert got == jax_layout(pb, raw, max_keyframes) == [5]


# --------------------------------------------------------------------- #
# the header
# --------------------------------------------------------------------- #
HEADERS = [
    [{"fx": 400.0, "fy": 400.0, "cx": 320.0, "cy": 240.0}],
    [{"fx": 260.123456789, "fy": 1e-5, "cx": -3.5, "cy": 1e20},
     {"fx": 0.1, "fy": 2.0**31, "cx": float("inf"), "cy": -0.0}],
    [],
]


@pytest.mark.parametrize("mats", HEADERS)
def test_header_against_opencv_and_yaml(tmp_path, mats):
    cv2 = pytest.importorskip("cv2")
    yaml = pytest.importorskip("yaml")
    header = {"Options": 24, "mappointsFile": str(tmp_path / "a map.mappoints"),
              "nMappoints": 1952, "keyframesFile": "plain", "nKeyframes": 21,
              "featuresFile": str(tmp_path / "m.features"), "nFeatures": 17421,
              "cameraMatrices": mats, "loopEdges": []}
    port, ocv, plain = (str(tmp_path / n) for n in ("port.yaml", "cv.yaml", "plain.yaml"))
    filestorage.write_header(port, header)
    fs = cv2.FileStorage(ocv, cv2.FILE_STORAGE_WRITE)
    for k in filestorage.FILE_KEYS:
        fs.write(k, header[k])
    for k in filestorage.COUNT_KEYS:
        fs.write(k, int(header[k]))
    fs.startWriteStruct("cameraMatrices", cv2.FILE_NODE_SEQ)
    for kmat in mats:
        fs.startWriteStruct("", cv2.FILE_NODE_MAP | cv2.FILE_NODE_FLOW)
        for k in filestorage.K_KEYS:
            fs.write(k, float(kmat[k]))
        fs.endWriteStruct()
    fs.endWriteStruct()
    fs.release()
    with open(plain, "w") as f:
        yaml.safe_dump(header, f)
    with open(port) as f, open(ocv) as g:
        mine, theirs = f.read(), g.read()
    assert mine.startswith("%YAML:1.0\n---\n")
    assert mine.split("\n", 1)[1] == theirs.split("\n", 1)[1]  # all but the directive line

    expect = {k: header[k] for k in filestorage.FILE_KEYS + filestorage.COUNT_KEYS}
    expect["cameraMatrices"] = mats
    fs = cv2.FileStorage(port, cv2.FILE_STORAGE_READ)
    read = {k: fs.getNode(k).string() for k in filestorage.FILE_KEYS}
    read.update({k: int(fs.getNode(k).real()) for k in filestorage.COUNT_KEYS})
    node = fs.getNode("cameraMatrices")
    read["cameraMatrices"] = [{k: node.at(i).getNode(k).real() for k in filestorage.K_KEYS}
                              for i in range(node.size())]
    fs.release()
    for got in (read, filestorage.read_header(port), filestorage.read_header(ocv),
                filestorage.read_header(plain)):
        assert got == expect  # by value: FileStorage writes -0.0 as "0."


def test_header_reads_opencv_4_reals(tmp_path):
    path = str(tmp_path / "old.yaml")
    with open(path, "w") as f:
        f.write('%YAML:1.0\n---\nmappointsFile: "m.mappoints"\nnMappoints: 3\nOptions: 16\n'
                "cameraMatrices:\n   - { fx:4.0000000000000000e+02, fy:400., cx:3.2e+02,\n"
                "       cy:.Inf }\n")
    assert filestorage.read_header(path) == {
        "mappointsFile": "m.mappoints", "nMappoints": 3, "Options": 16,
        "cameraMatrices": [{"fx": 400.0, "fy": 400.0, "cx": 320.0, "cy": float("inf")}]}


# --------------------------------------------------------------------- #
# the system
# --------------------------------------------------------------------- #
def test_load_and_resume(mapped, frames, tmp_path):
    base = str(tmp_path / "resume")
    mapped.save_map(base)
    sys2 = System(config(), device="cpu")
    sys2.load_map(base)
    assert sys2.state == TrackingState.LOST
    assert sys2.store.n_keyframes() == mapped.store.n_keyframes()
    state, Tcw = sys2.track_monocular(frames[12], timestamp=99.0)
    assert state == TrackingState.OK
    rec = [T for (_, fid, _, _, _, T) in mapped.tracker.trajectory if fid == 12][0]
    dR = Tcw[:3, :3] @ rec[:3, :3].T
    assert np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)) < 0.05
    assert np.linalg.norm(Tcw[:3, 3] - rec[:3, 3]) < 0.2


def test_system_load_equals_the_jax_package(mapped, jax_io, tmp_path):
    from os1_tpu.features.orb import OrbConfig as JOrb
    from os1_tpu.geometry.camera import Camera as JCamera
    from os1_tpu.pipeline import SlamConfig as JSlam
    from os1_tpu.pipeline import System as JSystem

    base = str(tmp_path / "map")
    mapped.save_map(base)
    _, _, JMapConfig, _ = jax_io
    jsys = JSystem(cfg=JSlam(camera=JCamera.make(fx=260.0, fy=260.0, cx=160.0, cy=120.0,
                                                 width=W, height=H),
                             orb=JOrb(height=H, width=W, n_features=512, n_levels=4),
                             map=JMapConfig(max_keyframes=64, max_points=8192, n_features=512)),
                   distributed=False)
    tsys = System(config(), device="cpu")
    assert jsys.load_map(base) == tsys.load_map(base)
    assert_stores_equal(tsys.store, jsys.store)
    assert tsys.state.name == jsys.state.name == "LOST"
    assert tsys.tracker.ref_kf == jsys.tracker.ref_kf >= 0
    np.testing.assert_array_equal(tsys.db.active, jsys.db.active)
    for k in np.nonzero(tsys.db.active)[0]:
        a, b = tsys.db.bows[k], jsys.db.bows[k]
        np.testing.assert_array_equal(a.words, b.words)
        np.testing.assert_array_equal(a.weights, b.weights)
    assert tsys.tracker.last is None and tsys.tracker.velocity is None


def test_shipped_mode_saves_materialized_keyframes(frames, tmp_path):
    sys_ = System(config(), pipelined=True, coop_mapping=True, device="cpu")
    waiting = False
    for i, f in enumerate(frames):
        sys_.track_monocular(f, timestamp=i / 30.0)
        if i > 10 and sys_._pending_frames:
            waiting = True
            break
    assert waiting, "no keyframe waited for its features"
    live = set(np.nonzero(sys_.store.kf_valid)[0].tolist())
    assert set(sys_._pending_frames) & live
    base = str(tmp_path / "shipped")
    header = sys_.save_map(base)
    assert not sys_._pending_frames and not sys_.coop.busy()
    assert header["nKeyframes"] == sys_.store.n_keyframes()
    with open(base + ".features", "rb") as f:
        entries = osmap_io.read_features(f.read(), 64)
    assert sorted(e.get("keyframe_id", 0) for e in entries) == sorted(live)
    for e in entries:
        feats = e.get("feature", [])
        assert len(feats) == int(sys_.store.kf_feat_valid[e.get("keyframe_id", 0)].sum()) > 0
        assert any(any(f["briefdescriptor"]["block"]) for f in feats)
        assert any("keypoint" in f and f["keypoint"] for f in feats)
    assert os.path.getsize(base + ".mappoints") > 0
