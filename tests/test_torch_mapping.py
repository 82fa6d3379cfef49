"""Port parity of synchronous local mapping: the JAX System and the port's,
both as System(enable_mapping=True, enable_loop_closing=False,
pipelined=False), at 240x320, 512 features, 4 levels, MapConfig(64, 8192,
512), on the first 28 frames of orbit_trajectory(40, advance=0.08) of
default_scene(seed=3) (the JAX package's own pipeline test sequence). The JAX
system runs on one device (distributed=False); the RANSAC draws are replayed.

The whole slice: the same state sequence and keyframe count on every frame,
at least one keyframe culled in both; per-frame poses, read through the
culled-keyframe walk, within atol 1e-3 (measured 1.6e-4: float32 solves
summed in another order); point counts within 1% (measured: equal on every
frame).
The run stops at frame 28 because frame 29's keyframe decision sits on its
threshold (301 tracked inliers against 0.9 x 334 or 335 reference points, one
observation apart after float32 pose solves that differ by one inlier): past
it the two runs insert the same keyframe a frame apart.

Each stage is also held against its JAX twin on the same map: the JAX store
as it stood before its last keyframe's mapping pass, handed to the port
through os1_tpu_torch.convert (it culls a keyframe and adds points). K8
triangulation: codes, neighbour features and far flags exact, points within
1e-3 of the points' extent (DLT in float32; measured 6.5e-4 at an extent of
1.37), parallax cosines within 1e-5 (measured 3e-7). K9 fusion: codes exact.
K10 assembly: every table exact (gathers). One local BA (5 + 10 LM
iterations): poses within 1e-4 (measured 1.5e-5), points within 1e-3
(measured 1.5e-4), inlier masks exact. One whole LocalMapper.process: the
same points, observations, culls and spanning tree; poses within 1e-4
(measured 1.2e-7), points within 1e-3 (measured 5.4e-6).

The local mapper's ``ba_iters`` over the slice equals the JAX mapper's.

The viewer's far-point trackbar: ``System.set_far_parallax_param`` sets the
mapper's threshold as the JAX package's does, and the same pass with the
threshold at 0.999 gives the same ``pt_far_class`` in both packages (exact),
with more umbralCosBajo points than at the default 0.9998.
"""
import copy

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from os1_tpu.features.orb import OrbConfig as JOrb  # noqa: E402
from os1_tpu.geometry.camera import Camera as JCamera  # noqa: E402
from os1_tpu.io import synthetic  # noqa: E402
from os1_tpu.map.mirror import DeviceMirror as JMirror  # noqa: E402
from os1_tpu.map.store import MapConfig as JMap  # noqa: E402
from os1_tpu.optim import ba_core as jba  # noqa: E402
from os1_tpu.pipeline import SlamConfig as JSlam  # noqa: E402
from os1_tpu.pipeline import System as JSystem  # noqa: E402
from os1_tpu.pipeline import tracking_kernels as jtk  # noqa: E402
from os1_tpu.pipeline.local_mapping import LocalMapper as JMapper  # noqa: E402
from os1_tpu_torch import convert  # noqa: E402
from os1_tpu_torch.map.mirror import DeviceMirror  # noqa: E402
from os1_tpu_torch.map.store import MapConfig  # noqa: E402
from os1_tpu_torch.optim import ba_core as tba  # noqa: E402
from os1_tpu_torch.pipeline import SlamConfig, System  # noqa: E402
from os1_tpu_torch.pipeline import tracking_kernels as ttk  # noqa: E402
from os1_tpu_torch.pipeline.local_mapping import LocalMapper  # noqa: E402

from test_torch_slice import ReplaySampler  # noqa: E402

H, W = 240, 320
K = np.array([[260.0, 0, 160.0], [0, 260.0, 120.0], [0, 0, 1.0]])
N_FRAMES = 28
SLICE = dict(enable_mapping=True, enable_loop_closing=False, pipelined=False)


def _jax_system():
    cam = JCamera.make(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2], width=W, height=H)
    cfg = JSlam(camera=cam, orb=JOrb(height=H, width=W, n_features=512, n_levels=4),
                map=JMap(max_keyframes=64, max_points=8192, n_features=512))
    return JSystem(cfg=cfg, distributed=False, **SLICE)


def _port_config(jcfg):
    return SlamConfig(camera=convert.camera_from_numpy(jcfg.camera, device="cpu"),
                      orb=convert.orb_config_from_fields(jcfg.orb),
                      map=MapConfig(max_keyframes=64, max_points=8192, n_features=512))


@pytest.fixture(scope="module")
def runs():
    scene = synthetic.default_scene(seed=3)
    poses = synthetic.orbit_trajectory(40, advance=0.08)
    frames = synthetic.render_sequence(scene, poses[:N_FRAMES], K, H, W)
    jsys = _jax_system()
    tsys = System(_port_config(jsys.cfg), device="cpu", sampler=ReplaySampler(), **SLICE)
    # The JAX store as it stands before each keyframe's mapping pass.
    snaps = []
    process = jsys.mapper.process

    def snapshot_then_process(kf, bootstrap=False):
        if not bootstrap:
            snaps.append((int(kf), int(jsys.tracker.ref_kf), copy.deepcopy(jsys.store)))
        return process(kf, bootstrap=bootstrap)

    jsys.mapper.process = snapshot_then_process
    js, ts = [], []
    for i in range(N_FRAMES):
        state = jsys.track_monocular(frames[i], timestamp=i / 30.0)[0]
        js.append((state.name, jsys.store.n_keyframes(), jsys.store.n_points()))
        state = tsys.track_monocular(frames[i], timestamp=i / 30.0)[0]
        ts.append((state.name, tsys.store.n_keyframes(), tsys.store.n_points()))
    return dict(jsys=jsys, tsys=tsys, js=js, ts=ts, poses=poses, snap=snaps[-1])


def test_mapping_slice_matches_jax(runs):
    js, ts = runs["js"], runs["ts"]
    assert [s[:2] for s in ts] == [s[:2] for s in js]
    assert all(s[0] == "OK" for s in js[2:])
    for (_, _, pj), (_, _, pt) in zip(js, ts):
        assert abs(pt - pj) <= 0.01 * max(pj, 1)
    jsys, tsys = runs["jsys"], runs["tsys"]
    assert jsys.store._kf_seq_next == tsys.store._kf_seq_next
    culled = jsys.store._kf_seq_next - jsys.store.n_keyframes()
    assert culled > 0 and tsys.store.culled_links.keys() == jsys.store.culled_links.keys()
    tj, tt = jsys.frame_trajectory(), tsys.frame_trajectory()
    assert [f for _, f, _ in tt] == [f for _, f, _ in tj]
    for (_, _, Tj), (_, _, Tt) in zip(tj, tt):
        np.testing.assert_allclose(Tt, Tj, atol=1e-3)
    poses = runs["poses"]
    ate_j = synthetic.ate_rmse([T for *_, T in tj], [poses[f] for _, f, _ in tj])
    ate_t = synthetic.ate_rmse([T for *_, T in tt], [poses[f] for _, f, _ in tt])
    assert ate_t <= ate_j + 0.005 and ate_j < 0.2


def test_ba_iters_matches_jax(runs):
    """The local BA's LM iterations over the slice's keyframe passes (5 for
    the first phase, 5 for each chunk that runs), as the JAX mapper counts
    them for bench.py's local-BA iterations/s."""
    j, t = runs["jsys"].mapper.ba_iters, runs["tsys"].mapper.ba_iters
    assert t == j and j > 0 and j % 5 == 0


# ---------------------------------------------------------------------- #
# Stages on the same map
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def same_map(runs):
    """(kf, protected kf, JAX store, port store, JAX config, port config) of
    the last keyframe's mapping pass, before it ran."""
    kf, ref, jstore = runs["snap"]
    jcfg = runs["jsys"].cfg
    return kf, ref, jstore, convert.store_from_numpy(jstore), jcfg, _port_config(jcfg)


def _port_mapper(st, cfg, ref):
    m = LocalMapper(cfg=cfg, store=st, mirror=DeviceMirror(st, "cpu"))
    m.protected_kf_fn = lambda: ref
    return m


def _jax_mapper(st, cfg, ref):
    m = JMapper(cfg=cfg, store=st)
    m.mirror = JMirror(st)
    m.publish_points = m.mirror.refresh_dynamic
    m.protected_kf_fn = lambda: ref
    return m


def _tri_inputs(st, kf, nb_count):
    nbs = [int(n) for n in st.covisible_keyframes(kf, top=nb_count)]
    all_nb = np.array(nbs + [kf] * (nb_count - len(nbs)), np.int64)
    own = st.kf_obs_point[kf]
    own = np.unique(own[own >= 0])
    z = (st.pt_xyz[own] @ st.kf_T[kf][:3, :3].T + st.kf_T[kf][:3, 3])[:, 2]
    md = float(np.median(z[z > 0]))
    unb_new = st.kf_feat_valid[kf] & (st.kf_obs_point[kf] < 0)
    unb_nb = st.kf_feat_valid[all_nb] & (st.kf_obs_point[all_nb] < 0)
    return all_nb, md, unb_new, unb_nb


def test_triangulation_on_the_same_map(same_map):
    kf, _, jst, tst, jcfg, cfg = same_map
    NB = cfg.th.triangulation_neighbors
    all_nb, md, unb_new, unb_nb = _tri_inputs(tst, kf, NB)
    jm = JMirror(jst)
    Kj = jnp.asarray(K.astype(np.float32))
    out_j = [np.asarray(a) for a in jtk.triangulate_mirror_batch(
        jnp.asarray(jst.kf_T[kf]), jnp.asarray(jst.kf_T[all_nb]), jnp.int32(kf),
        jnp.asarray(all_nb.astype(np.int32)), jm.kf_xy, jm.kf_angle, jm.kf_octave, jm.kf_desc,
        jnp.asarray(unb_new), jnp.asarray(unb_nb), Kj, jnp.asarray(jcfg.sigma2_table),
        jnp.float32(md), enable_far=False)]
    tm = DeviceMirror(tst, "cpu")
    t = torch.from_numpy
    out_t = [a.numpy() for a in ttk.triangulate_mirror_batch(
        t(tst.kf_T[kf]), t(tst.kf_T[all_nb]), kf, t(all_nb), tm.kf_xy, tm.kf_angle,
        tm.kf_octave, tm.kf_desc, t(unb_new), t(unb_nb), t(K.astype(np.float32)),
        t(cfg.sigma2_table), torch.tensor(md, dtype=torch.float32), enable_far=False)]
    code_j, pts_j, far_j, nbf_j, cos_j = out_j
    code_t, pts_t, far_t, nbf_t, cos_t = out_t
    ok = code_j >= 0
    assert ok.sum() > 20
    np.testing.assert_array_equal(code_t, code_j)
    np.testing.assert_array_equal(far_t[ok], far_j[ok])
    np.testing.assert_array_equal(nbf_t[ok], nbf_j[ok])
    scale = np.abs(pts_j[ok]).max()
    np.testing.assert_allclose(pts_t[ok], pts_j[ok], atol=1e-3 * scale)
    np.testing.assert_allclose(cos_t[ok], cos_j[ok], atol=1e-5)


def test_fusion_on_the_same_map(same_map):
    kf, ref, jst, tst, jcfg, cfg = same_map
    targets = _port_mapper(tst, cfg, ref)._fuse_targets(kf)[:45]
    assert targets == _jax_mapper(copy.deepcopy(jst), jcfg, ref)._fuse_targets(kf)[:45]
    tgt = targets + [kf] * len(targets)
    src = [kf] * len(targets) + targets
    L = len(tgt)
    jm = JMirror(jst)
    code_j = np.asarray(jtk.fuse_pairs_mirror(
        jnp.asarray(jst.kf_T[tgt]), jnp.asarray(np.int32(tgt)), jnp.asarray(np.int32(src)),
        jnp.ones(L, bool), jm.kf_xy, jm.kf_angle, jm.kf_octave, jm.kf_desc, jm.kf_feat_valid,
        jm.kf_obs_point, jm.pt_xyz, jm.pt_desc, jm.pt_max_dist, jm.pt_valid, jm.pt_obs_kf,
        jnp.asarray(jcfg.intr), jnp.float32(W), jnp.float32(H), jnp.float32(jcfg.orb.scale_factor),
        n_levels=jcfg.orb.n_levels))
    tm = DeviceMirror(tst, "cpu")
    t = torch.from_numpy
    code_t = ttk.fuse_pairs_mirror(
        t(tst.kf_T[tgt]), t(np.int64(tgt)), t(np.int64(src)), tm.kf_xy, tm.kf_angle,
        tm.kf_octave, tm.kf_desc, tm.kf_feat_valid, tm.kf_obs_point, tm.pt_xyz, tm.pt_desc,
        tm.pt_max_dist, tm.pt_valid, tm.pt_obs_kf, t(cfg.intr), float(W), float(H),
        cfg.orb.scale_factor, n_levels=cfg.orb.n_levels).numpy()
    assert (code_j >= 0).sum() > 10
    np.testing.assert_array_equal(code_t, code_j)


def _ba_problems(same_map):
    kf, ref, jst, tst, jcfg, cfg = same_map
    prob_j, meta_j = _jax_mapper(copy.deepcopy(jst), jcfg, ref)._local_ba_assemble(kf)
    tst = copy.deepcopy(tst)
    prob_t, meta_t = _port_mapper(tst, cfg, ref)._local_ba_assemble(kf)
    return prob_j, meta_j, prob_t, meta_t


def test_ba_assembly_on_the_same_map(same_map):
    prob_j, meta_j, prob_t, meta_t = _ba_problems(same_map)
    for name in ("cam_T", "cam_fixed", "points", "point_valid", "obs_cam", "obs_uv",
                 "obs_sigma2", "obs_valid"):
        np.testing.assert_array_equal(getattr(prob_t, name).numpy(),
                                      np.asarray(getattr(prob_j, name)), err_msg=name)
    assert meta_t["cam_slot"] == meta_j["cam_slot"]
    np.testing.assert_array_equal(meta_t["pts"], meta_j["pts"])
    assert int(np.asarray(prob_j.obs_valid).sum()) > 200


def test_local_ba_on_the_same_map(same_map):
    prob_j, _, prob_t, _ = _ba_problems(same_map)
    sj = jba.ba_begin(prob_j)
    sj = jba.ba_reclassify(prob_j, jba.ba_iterate(prob_j, sj, 5))
    rj = jba.ba_result(prob_j, jba.ba_iterate(prob_j, sj, 10))
    st = tba.ba_begin(prob_t)
    st = tba.ba_reclassify(prob_t, tba.ba_iterate(prob_t, st, 5))
    rt = tba.ba_result(prob_t, tba.ba_iterate(prob_t, st, 10))
    np.testing.assert_array_equal(rt.obs_inlier.numpy(), np.asarray(rj.obs_inlier))
    np.testing.assert_allclose(rt.cam_T.numpy(), np.asarray(rj.cam_T), atol=1e-4)
    valid = np.asarray(prob_j.point_valid)
    np.testing.assert_allclose(rt.points.numpy()[valid], np.asarray(rj.points)[valid], atol=1e-3)
    moved = np.abs(np.asarray(rj.cam_T) - np.asarray(prob_j.cam_T)).max()
    assert moved > 1e-5  # the solve did something


def test_local_mapper_process_on_the_same_map(same_map):
    kf, ref, jst, tst, jcfg, cfg = same_map
    jst, tst = copy.deepcopy(jst), copy.deepcopy(tst)
    n_kf, n_pt = jst.n_keyframes(), jst.n_points()
    _jax_mapper(jst, jcfg, ref).process(kf)
    _port_mapper(tst, cfg, ref).process(kf)
    for name in ("pt_valid", "kf_valid", "kf_obs_point", "pt_obs_kf", "pt_obs_feat", "pt_n_obs",
                 "kf_parent", "pt_first_seq", "pt_far"):
        np.testing.assert_array_equal(getattr(tst, name), getattr(jst, name), err_msg=name)
    assert tst.culled_links.keys() == jst.culled_links.keys()
    assert jst.n_points() != n_pt or jst.n_keyframes() != n_kf
    np.testing.assert_allclose(tst.kf_T, jst.kf_T, atol=1e-4)
    v = jst.pt_valid
    np.testing.assert_allclose(tst.pt_xyz[v], jst.pt_xyz[v], atol=1e-3)


def test_far_parallax_param_matches_jax(runs, same_map):
    """The viewer's parallax trackbar: System.set_far_parallax_param sets the
    mapper's threshold as the JAX package's does, and a pass with it set
    classes the new points' pt_far_class the same way in both packages."""
    jsys, tsys = runs["jsys"], runs["tsys"]
    try:
        for param in (0, 500, 990, 997, 998, 1000):
            jsys.set_far_parallax_param(param)
            tsys.set_far_parallax_param(param)
            assert tsys.mapper.far_cos_user == jsys.mapper.far_cos_user
    finally:
        jsys.set_far_parallax_param(1000)
        tsys.set_far_parallax_param(1000)
    kf, ref, jst, tst, jcfg, cfg = same_map
    classes = []
    for param in (1000, 990):
        js_, ts_ = copy.deepcopy(jst), copy.deepcopy(tst)
        jm, tm = _jax_mapper(js_, jcfg, ref), _port_mapper(ts_, cfg, ref)
        jm.far_cos_user = tm.far_cos_user = 0.9 + param / 10000.0 if param < 998 else 0.9998
        jm.process(kf)
        tm.process(kf)
        np.testing.assert_array_equal(ts_.pt_valid, js_.pt_valid)
        np.testing.assert_array_equal(ts_.pt_far_class, js_.pt_far_class)
        new = ts_.pt_valid & (ts_.pt_first_seq == ts_.kf_seq[kf])
        classes.append(np.bincount(ts_.pt_far_class[new], minlength=4))
    # The lower threshold (cos 0.999) moves new points into umbralCosBajo.
    assert classes[1][1] > classes[0][1] and classes[1].sum() == classes[0].sum()
