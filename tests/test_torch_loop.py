"""Port parity of loop closing (os1_tpu_torch.pipeline.loop_closing) and
global BA (os1_tpu_torch.pipeline.local_mapping), against the JAX package on
the hand-built looped map of tests/test_loop_closing.py (a keyframe chain whose
return leg revisits the start under an injected Sim3 drift), carried across
with os1_tpu_torch.convert (store, BoW database, loop closer state):

- ``detect`` over the return leg: the same candidates and the same
  consistency groups and counts after every keyframe.
- The Sim3 candidate program on the first accepted (keyframe, candidate)
  pair, the JAX draw handed over (a sampler replaying ``lax.top_k`` of
  ``jax.random.gumbel`` over the matched pairs): the same matched pairs, pair
  inliers, success and counts exactly; S12 within atol 1e-4.
- ``correct`` with the JAX program's Sim3 and pairs: the same loop edges, the
  same fused points and observations exactly; poses and points within 1e-3.
- Global BA on the JAX package's corrected map: the assembled problem exact
  (the JAX package pads it to compile buckets, compared on its real part);
  the solve (20 LM iterations) within 1e-3 of the JAX solve; the apply of one
  result leaves both stores the same, exactly; ``global_bundle_adjustment``
  (assemble, solve, apply) the same map within 1e-3.
- The Sim3 LM's scale runaway (the 27 inlier pairs of a bench-size revisit
  whose keyframe centres are 8 mm apart, tests/data/sim3_scale_runaway.npz):
  the JAX package's LM and the port's both take Horn's 0.94 scale past 4
  (within 1% of each other), and the port's acceptance rejects the result
  (``lm_scale_consistent``), while it keeps a well-conditioned refinement.
- A keyframe not yet materialized (the cooperative mode's newest) joins the
  spanning tree at the correction, is no camera of the global BA and keeps
  its pose relative to its parent through the BA's write-back (within 1e-4).
- The whole ``process`` over the return leg (the JAX draws replayed on the
  JAX loop closer's key chain): the loop closes on the same keyframe against
  the same candidate, with the same loop edges; poses within 1e-3 after the
  correction and its global BA.
- The room circuit of tests/test_pipeline.py (160 frames of
  ``loop_trajectory`` through ``room_scene(seed=5)``, 320x240, 512 features,
  MapConfig(64, 8192)) through the port's System on the CPU in the mode the
  JAX test runs, sync with loop closing on, held to that test's own bounds: a
  loop closed, more than 100 OK frames, ATE under 3% of the path, finite
  poses and points, a consistent spanning tree. (The shipped mode loses track
  on this 320x240 circuit in both packages: the JAX package's coop run is
  OK on 55 of the 160 frames.)
- Marked ``cuda``: the candidate program on the card equals its run on the
  CPU on a synthetic two-keyframe loop (matches and masks exactly, S12 within
  1e-4), with the fused match kernel launched twice, for the bound-feature
  match and the guided projection. This test needs no JAX.
"""
import copy
import types

import numpy as np
import pytest
import torch

from os1_tpu_torch import convert
from os1_tpu_torch.map.store import MapConfig
from os1_tpu_torch.pipeline import SlamConfig
from os1_tpu_torch.pipeline import local_mapping as tlm
from os1_tpu_torch.pipeline import loop_closing as tlc


@pytest.fixture(scope="module")
def J():
    """The JAX package's modules (imported only by the tests that use them)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from os1_tpu.pipeline import local_mapping as jlm
    from os1_tpu.pipeline import loop_closing as jlc

    return types.SimpleNamespace(jax=jax, jnp=jnp, jlm=jlm, jlc=jlc)


@pytest.fixture(scope="module")
def looped_map(J):
    """The JAX loop-closing test's hand-built looped map."""
    import test_loop_closing

    return test_loop_closing.looped_map.__wrapped__()


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the float results do not depend on the host's
    core count, and parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class JaxDraws:
    """Sim3 RANSAC sampler replaying the JAX candidate program's draw:
    ``key`` per call, or the JAX loop closer's chain (split before each
    dispatch) from ``chain``."""

    def __init__(self, key=None, chain=None):
        self.key, self.chain = key, chain

    def __call__(self, valid, iters, k):
        import jax
        import jax.numpy as jnp

        key = self.key
        if self.chain is not None:
            self.chain, key = jax.random.split(self.chain)
        v = jnp.asarray(valid.cpu().numpy())
        g = jnp.where(v[None, :], jax.random.gumbel(key, (iters, v.shape[0])), -jnp.inf)
        return torch.from_numpy(np.asarray(jax.lax.top_k(g, k)[1]).astype(np.int64))


def _port_config(jcfg):
    return SlamConfig(camera=convert.camera_from_numpy(jcfg.camera, device="cpu"),
                      orb=convert.orb_config_from_fields(jcfg.orb),
                      map=MapConfig(**{k: getattr(jcfg.map, k) for k in
                                       ("max_keyframes", "max_points", "n_features")}))


@pytest.fixture(scope="module")
def pair(J, looped_map):
    """Both closers on copies of the looped map."""
    from os1_tpu_torch.vocab.dbow2 import default_vocabulary

    jcfg, jst, jdb, kf_ids, gt, D, drift_start = looped_map
    cfg = _port_config(jcfg)
    vocab = default_vocabulary()

    def make():
        st = copy.deepcopy(jst)
        jl = J.jlc.LoopCloser(cfg=jcfg, store=st, db=jdb)
        tl = tlc.LoopCloser(cfg=cfg, store=convert.store_from_numpy(st),
                            db=convert.database_from_numpy(jdb, vocab), device="cpu")
        return jl, tl

    return dict(make=make, kf_ids=kf_ids, start=drift_start, jcfg=jcfg, cfg=cfg, J=J)


def _first_accepted(jl, tl, kf_ids, start):
    """detect() on both closers over the return leg, compared after every
    keyframe; returns (kf, cand) of the first accepted candidate."""
    for k in range(start, len(kf_ids)):
        cj = jl.detect(kf_ids[k], k)
        ct = tl.detect(kf_ids[k], k)
        assert np.array_equal(ct, cj), k
        assert tl.consistent_groups == jl.consistent_groups, k
        if len(cj):
            return kf_ids[k], int(cj[0])
    raise AssertionError("no loop candidate accepted")


def test_detect_matches_jax(pair):
    jl, tl = pair["make"]()
    kf, cand = _first_accepted(jl, tl, pair["kf_ids"], pair["start"])
    assert cand not in {int(x) for x in tl.store.covisible_keyframes(kf, min_weight=15)}
    # The groups carried by convert give the same next verdict.
    jl2, tl2 = pair["make"]()
    convert.copy_loop_state(jl, tl2)
    assert tl2.consistent_groups == jl.consistent_groups


def _programs(pair):
    jax, jnp, jlc = pair["J"].jax, pair["J"].jnp, pair["J"].jlc
    jl, tl = pair["make"]()
    kf, cand = _first_accepted(jl, tl, pair["kf_ids"], pair["start"])
    snap_j = jl._snapshot_sim3(kf, cand)
    snap_t = tl._snapshot_sim3(kf, cand)
    for k, v in snap_j.items():
        assert np.array_equal(np.asarray(snap_t[k]), np.asarray(v)), k
    key = jax.random.PRNGKey(11)
    out_j = jlc._sim3_candidate_program(
        **{k: jnp.asarray(v) for k, v in snap_j.items()}, intr=jnp.asarray(pair["jcfg"].intr),
        sigma2_table=jnp.asarray(pair["jcfg"].sigma2_table), key=key)
    tl.sampler = JaxDraws(key)
    out_t = tl._run_sim3(snap_t)
    return jl, tl, kf, cand, [np.asarray(x) for x in out_j], [x.numpy() for x in out_t]


def test_sim3_program_matches_jax(pair):
    _, _, _, _, (hj, f1j, f2j, okj), (ht, f1t, f2t, okt) = _programs(pair)
    assert hj[0] == 1.0 and ht[0] == 1.0  # success
    np.testing.assert_array_equal(ht[:4], hj[:4])  # success, n_match, n_total, n_inliers
    np.testing.assert_array_equal(f1t, f1j)
    np.testing.assert_array_equal(f2t, f2j)
    np.testing.assert_array_equal(okt, okj)
    np.testing.assert_allclose(ht[4:20], hj[4:20], atol=1e-4)
    # The port's head also carries Horn's scale, the LM's (that of S12) and
    # the verdict without the scale guard, which agrees here.
    s12 = np.cbrt(np.linalg.det(ht[4:20].reshape(4, 4)[:3, :3].astype(np.float64)))
    assert abs(ht[21] - s12) < 1e-4 and abs(np.log(ht[21] / ht[20])) < np.log(1.5)
    assert ht[22] == 1.0


def test_upload_is_one_packed_copy():
    """transfer.upload: every dtype of a snapshot arrives with its bits (uint32
    as int32), shape and dtype, as new memory, not a view of the arrays."""
    from os1_tpu_torch.utils import transfer

    rng = np.random.default_rng(0)
    arrays = dict(desc=rng.integers(0, 2**32, (5, 8), dtype=np.uint64).astype(np.uint32),
                  ok=rng.random(7) > 0.5, xyz=rng.random((3, 3)).astype(np.float32),
                  idx=np.arange(3, dtype=np.int64), octave=np.arange(9, dtype=np.int8),
                  S=np.eye(4), empty=np.zeros((0, 3), np.float32))
    out = transfer.upload(arrays, "cpu")
    for k, a in arrays.items():
        want = torch.from_numpy((a.view(np.int32) if a.dtype == np.uint32 else a).copy())
        assert out[k].dtype == want.dtype and torch.equal(out[k], want), k
    out["xyz"][0, 0] = 7.0
    assert arrays["xyz"][0, 0] != 7.0


def _corrected(pair):
    jl, tl, kf, cand, (hj, f1j, f2j, okj), _ = _programs(pair)
    S_cl = hj[4:20].reshape(4, 4).astype(np.float32)
    pairs = np.stack([f1j[okj], f2j[okj]], axis=1)
    jl.correct(kf, cand, S_cl, pairs)
    tl.correct(kf, cand, S_cl, pairs.astype(np.int64))
    return jl, tl


def _same_map(jst, tst, atol):
    for name in ("kf_valid", "pt_valid", "kf_obs_point", "pt_obs_kf", "pt_obs_feat", "pt_n_obs",
                 "kf_parent"):
        np.testing.assert_array_equal(getattr(tst, name), getattr(jst, name), err_msg=name)
    live, pv = jst.kf_valid, jst.pt_valid
    np.testing.assert_allclose(tst.kf_T[live], jst.kf_T[live], atol=atol)
    np.testing.assert_allclose(tst.pt_xyz[pv], jst.pt_xyz[pv], atol=atol)


def test_correct_matches_jax(pair):
    jl, tl = _corrected(pair)
    assert tl.loop_edges == jl.loop_edges and len(tl.loop_edges) == 1
    _same_map(jl.store, tl.store, 1e-3)
    np.testing.assert_allclose(tl.store.pt_normal[jl.store.pt_valid],
                               jl.store.pt_normal[jl.store.pt_valid], atol=1e-3)


def test_global_ba_matches_jax(pair):
    jax, jlm = pair["J"].jax, pair["J"].jlm
    jl, _ = _corrected(pair)
    jcfg, cfg = pair["jcfg"], pair["cfg"]
    jst, tst = jl.store, convert.store_from_numpy(jl.store)  # the same corrected map
    jst_sync, tst_sync = copy.deepcopy(jst), convert.store_from_numpy(jst)
    prob_j, meta_j = jlm.assemble_global_ba(jst, jcfg)
    prob_t, meta_t = tlm.assemble_global_ba(tst, cfg, "cpu")
    C, P = prob_t.cam_T.shape[0], prob_t.points.shape[0]
    for f in ("cam_T", "cam_fixed", "points", "obs_cam", "obs_uv", "obs_sigma2", "obs_valid"):
        a = np.asarray(getattr(prob_j, f))[: C if f.startswith("cam") else P]
        np.testing.assert_array_equal(getattr(prob_t, f).numpy(), a, err_msg=f)
    assert meta_t["cams"] == meta_j["cams"] and np.array_equal(meta_t["pts"], meta_j["pts"])
    assert np.asarray(prob_j.cam_fixed)[C:].all() and not np.asarray(prob_j.point_valid)[P:].any()

    res_j = jax.device_get(jlm.run_ba(prob_j, iters=20))
    from os1_tpu_torch.optim import ba_begin, ba_iterate, ba_result

    res_t = ba_result(prob_t, ba_iterate(prob_t, ba_begin(prob_t), 20))
    np.testing.assert_allclose(res_t.cam_T.numpy(), res_j.cam_T[:C], atol=1e-3)
    np.testing.assert_allclose(res_t.points.numpy(), res_j.points[:P], atol=1e-3)
    # One result applied to both stores.
    res = res_j._replace(cam_T=res_j.cam_T[:C], points=res_j.points[:P],
                         obs_inlier=res_j.obs_inlier[:P])
    jlm.apply_global_ba(jst, jcfg, res_j, meta_j)
    tlm.apply_global_ba(tst, cfg, res, meta_t)
    _same_map(jst, tst, 0.0)
    # The synchronous form, each package on its own solve.
    jlm.global_bundle_adjustment(jst_sync, jcfg, iters=20)
    tlm.global_bundle_adjustment(tst_sync, cfg, "cpu", iters=20)
    _same_map(jst_sync, tst_sync, 1e-3)


def test_pending_keyframe_follows_the_correction(pair):
    """A keyframe whose features are still on the device (the cooperative
    mode's newest keyframes) joins the spanning tree at the correction, is no
    camera of the global BA, and keeps its pose relative to its parent
    through the BA's write-back."""
    from os1_tpu_torch.optim import ba_begin, ba_iterate, ba_result

    jl, tl, kf, cand, (hj, f1j, f2j, okj), _ = _programs(pair)
    st = tl.store
    live = np.nonzero(st.kf_valid)[0]
    newest = int(live[np.argmax(st.kf_seq[live])])
    assert newest != kf and st.kf_parent[newest] < 0
    st.kf_feat_valid[newest] = False  # pending: not materialized yet
    tl.correct(kf, cand, hj[4:20].reshape(4, 4).astype(np.float32),
               np.stack([f1j[okj], f2j[okj]], axis=1).astype(np.int64))
    parent = int(st.kf_parent[newest])
    assert parent >= 0 and st.kf_valid[parent]
    prob, meta = tlm.assemble_global_ba(st, pair["cfg"], "cpu")
    assert newest not in meta["cams"] and parent in meta["cams"]
    rel = st.kf_T[newest] @ np.linalg.inv(st.kf_T[parent])
    res = ba_result(prob, ba_iterate(prob, ba_begin(prob), 20))
    res = res._replace(cam_T=res.cam_T.numpy(), points=res.points.numpy(),
                       obs_inlier=res.obs_inlier.numpy())
    moved = np.abs(res.cam_T[meta["cam_slot"][parent]] - st.kf_T[parent]).max()
    tlm.apply_global_ba(st, pair["cfg"], res, meta)
    assert moved > 0
    np.testing.assert_allclose(st.kf_T[newest] @ np.linalg.inv(st.kf_T[parent]), rel, atol=1e-4)


def test_sim3_lm_scale_runaway_is_rejected(J):
    import os

    from os1_tpu.optim.sim3_opt import optimize_sim3 as jopt

    from os1_tpu_torch.geometry import sim3
    from os1_tpu_torch.optim.sim3_opt import optimize_sim3

    d = dict(np.load(os.path.join(os.path.dirname(__file__), "data", "sim3_scale_runaway.npz")))
    n = len(d["x1"])
    args = [d[k] for k in ("x1", "x2")], [d[k] for k in ("uv1", "uv2", "s2_1", "s2_2", "intr")]
    r = jopt(J.jnp.asarray(d["S0"]), *map(J.jnp.asarray, args[0]), J.jnp.ones(n, bool),
             *map(J.jnp.asarray, args[1]))
    t = optimize_sim3(torch.from_numpy(d["S0"]), *map(torch.from_numpy, args[0]),
                      torch.ones(n, dtype=torch.bool), *map(torch.from_numpy, args[1]))
    s0 = float(sim3.to_Rts(torch.from_numpy(d["S0"]))[2])
    s_j = float(sim3.to_Rts(torch.from_numpy(np.asarray(r.S12)))[2])
    s_t = float(sim3.to_Rts(t.S12)[2])
    assert 0.9 < s0 < 1.0 and s_j > 4.0 and s_t > 4.0
    assert abs(s_t / s_j - 1.0) < 0.01
    assert not bool(tlc.lm_scale_consistent(torch.from_numpy(d["S0"]), t.S12))
    # A well-conditioned refinement keeps its scale: the noisy-init case.
    from test_loop_solvers import make_sim3_case

    x1, x2, uv1, uv2, S12 = make_sim3_case(np.random.default_rng(0))
    noise = torch.tensor([0.03, -0.02, 0.01, 0.01, -0.02, 0.015, 0.05])
    S0 = sim3.exp(noise) @ torch.from_numpy(S12)
    m = len(x1)
    t = optimize_sim3(S0, torch.from_numpy(x1), torch.from_numpy(x2),
                      torch.ones(m, dtype=torch.bool), torch.from_numpy(uv1),
                      torch.from_numpy(uv2), torch.ones(m), torch.ones(m),
                      torch.tensor([400.0, 400.0, 320.0, 240.0]))
    assert bool(tlc.lm_scale_consistent(S0, t.S12))


def test_process_closes_like_jax(pair):
    jl, tl = pair["make"]()
    tl.sampler = JaxDraws(chain=pair["J"].jax.random.PRNGKey(7))
    kf_ids, start = pair["kf_ids"], pair["start"]
    for k in range(start, len(kf_ids)):
        cj = jl.process(kf_ids[k], k)
        ct = tl.process(kf_ids[k], k)
        assert ct == cj, k
        if cj:
            break
    assert cj, "the JAX closer closed no loop"
    assert tl.n_loops_closed == jl.n_loops_closed == 1
    assert tl.loop_edges == jl.loop_edges
    _same_map(jl.store, tl.store, 1e-3)
    kf, cand, *_, success_ref, success = tl.sim3_log[-1]
    assert (min(kf, cand), max(kf, cand)) == tl.loop_edges[0] and success_ref and success
    assert not any(ref for *_, ref, _ in tl.sim3_log[:-1])


def test_reanchoring_keeps_the_motion_model():
    """After a correction the system drops the frames in flight, keeping
    them to be tracked again (the JAX package discards them), and remaps
    the last frame's pose through its reference keyframe's corrected pose,
    as the JAX package does; the motion model survives, with the previous
    pose remapped alongside (the JAX package clears it, and the pipelined
    frame after a correction, predicted with no motion, was lost on the
    card). Without a remap the motion model is cleared."""
    from os1_tpu_torch.features.orb import OrbConfig
    from os1_tpu_torch.geometry import se3
    from os1_tpu_torch.geometry.camera import Camera
    from os1_tpu_torch.pipeline import System
    from os1_tpu_torch.pipeline.tracking import TrackedFrame

    cfg = SlamConfig(camera=Camera.make(100.0, 100.0, 40.0, 30.0, width=80, height=60,
                                        device="cpu"),
                     orb=OrbConfig(height=60, width=80, n_features=64, n_levels=2),
                     map=MapConfig(max_keyframes=4, max_points=64, n_features=64))

    def pose(w, t):
        return se3.exp(torch.tensor(w + t, dtype=torch.float64)).numpy().astype(np.float32)

    for remap in (True, False):
        sys_ = System(cfg, pipelined=True, coop_mapping=True, device="cpu")
        st, tr = sys_.store, sys_.tracker
        T_ref = pose([0.01, 0.2, 0.0], [0.3, 0.0, 0.1])
        tr.ref_kf = st.add_keyframe_pending(T_ref, frame_id=4)
        T_prev = pose([0.01, 0.23, 0.0], [0.32, 0.0, 0.1])
        T_last = pose([0.01, 0.26, 0.0], [0.35, 0.01, 0.1])
        tr.velocity = T_last @ np.linalg.inv(T_prev)
        tr.last = TrackedFrame(data=None, Tcw=T_last, bind=np.full(64, -1), frame_id=7,
                               timestamp=7 / 30)
        tr._record_trajectory(7 / 30, 7, T_last)
        tr._pending = [("frame 8", 8, 8 / 30, "packed", "local ids", 0, "gen")]
        tr._chain = {"T": None}
        G = pose([0.0, 0.05, 0.02], [0.1, -0.2, 0.05])  # the correction moves the world
        st.kf_T[tr.ref_kf] = T_ref @ G
        if not remap:
            st.kf_seq[tr.ref_kf] += 1  # the reference keyframe no longer the recorded one
        sys_._after_loop_correction()
        assert tr._pending == [] and tr._chain is None
        assert tr._dropped == [("frame 8", 8, 8 / 30)]  # tracked again before the next frame
        if remap:
            np.testing.assert_allclose(tr.last.Tcw, T_last @ G, atol=1e-5)
            np.testing.assert_allclose(tr.velocity, T_last @ np.linalg.inv(T_prev), atol=1e-6)
            np.testing.assert_allclose(tr._prev_Tcw, T_prev @ G, atol=1e-5)
            np.testing.assert_allclose(tr.last.Tcw @ np.linalg.inv(tr._prev_Tcw), tr.velocity,
                                       atol=1e-5)
        else:
            np.testing.assert_array_equal(tr.last.Tcw, T_last)
            assert tr.velocity is None and tr._prev_Tcw is None


def _straddled_correction(plant=None, between=False):
    """The shipped mode at the test size, with an identity correction
    through the loop closer's ``on_corrected`` callback landing between
    frame AT's dispatch and its tail, two more frames in flight, or with
    ``between`` after frame AT's call, before the next. ``plant`` wraps the
    system before the run. Returns the system and what the tracker held at
    the correction."""
    from os1_tpu_torch.features.orb import OrbConfig
    from os1_tpu_torch.geometry.camera import Camera
    from os1_tpu_torch.io import synthetic
    from os1_tpu_torch.pipeline import System

    H, W = 240, 320
    K = np.array([[260.0, 0, 160.0], [0, 260.0, 120.0], [0, 0, 1.0]])
    poses = synthetic.loop_trajectory(160, radius=1.5, revolutions=1.15)[:STRADDLE_N]
    frames = synthetic.render_sequence(synthetic.room_scene(seed=5), poses, K, H, W)
    cfg = SlamConfig(camera=Camera.make(260.0, 260.0, 160.0, 120.0, width=W, height=H,
                                        device="cpu"),
                     orb=OrbConfig(height=H, width=W, n_features=512, n_levels=4),
                     map=MapConfig(max_keyframes=64, max_points=8192, n_features=512))
    sys_ = System(cfg, pipelined=True, coop_mapping=True, device="cpu")
    tr = sys_.tracker
    dispatch, seen = tr._dispatch_fused, {}

    def straddled(frame, *a):
        out = dispatch(frame, *a)
        if tr.frame_id - 1 == STRADDLE_AT and not seen and not between:
            seen.update(last=tr.last.frame_id, in_flight=[e[1] for e in tr._pending])
            sys_.loop_closer.on_corrected()  # lands between this frame's dispatch and its tail
        return out

    tr._dispatch_fused = straddled
    if plant is not None:
        plant(sys_, seen)
    for i, f in enumerate(frames):
        sys_.track_monocular(f, timestamp=i / 30.0)
        if between and i == STRADDLE_AT:
            seen.update(last=tr.last.frame_id, in_flight=[e[1] for e in tr._pending])
            sys_.loop_closer.on_corrected()  # as the LoopClosing thread lands it between frames
    sys_.flush()
    return sys_, seen


STRADDLE_AT, STRADDLE_N = 28, 33


def test_frames_dropped_by_a_correction_are_tracked():
    """A correction that lands while a frame's dispatch straddles it, with
    two more frames in flight (the threaded mode's LoopClosing thread can
    land it at any point of a frame): the dropped frames are tracked again
    from the remapped pose, each predicted one frame ahead of the frame
    before it, so no frame id is missing and none is lost after it. The
    JAX package's re-anchoring discards them: the next frame, four frames
    past the last one applied, was predicted one frame ahead on a chain
    whose velocity then spanned four frames, and on the room circuit the
    second frame after it was lost (its motion search and the
    reference-keyframe fallback both failed)."""
    AT, N = STRADDLE_AT, STRADDLE_N
    sys_, seen = _straddled_correction()
    tr = sys_.tracker
    assert seen == dict(last=AT - 3, in_flight=[AT - 2, AT - 1])
    lost = [f for f, _ in tr.loss_log if f > seen["last"]]
    assert not lost, tr.loss_log
    fids = [f for _, f, _ in sys_.frame_trajectory()]
    assert fids == sorted(fids) and set(range(seen["last"], N)) <= set(fids), fids


def test_a_lost_replayed_frame_skips_no_later_frame(monkeypatch):
    """A correction lands between two frames' calls, the map then tracks at
    depth 1 (as a map under eight keyframes does), so the next call's replay
    of the two dropped frames applies the first, and that frame is lost
    (planted): the frame in flight on its chain is discarded, as after any
    loss, and the frame in the call goes through the state machine as a new
    frame would, so it is relocalized, not skipped, and each frame from
    there on is tracked, lost or handed to the relocalizer."""
    from os1_tpu_torch.pipeline import tracking

    AT, N = STRADDLE_AT, STRADDLE_N
    planted, relocalized = [], []

    def plant(sys_, seen):
        tr, corrected = sys_.tracker, sys_.loop_closer.on_corrected
        apply, reloc = tr._apply_result, tr._relocalize

        def corrected_then_shallow():
            corrected()
            monkeypatch.setattr(tracking, "PIPELINE_DEPTH", 1)

        def apply_or_lose(frame, fid, timestamp, *rest):
            if seen and fid == seen["in_flight"][0] and not planted:  # its replay
                planted.append(fid)
                with tr.lock:
                    tr._mark_lost(frame, fid, timestamp, tr.last.Tcw, info="planted")
                return None
            return apply(frame, fid, timestamp, *rest)

        def traced(frame, fid, timestamp):
            relocalized.append(fid)
            return reloc(frame, fid, timestamp)

        tr._apply_result, tr._relocalize = apply_or_lose, traced
        sys_.loop_closer.on_corrected = corrected_then_shallow

    sys_, seen = _straddled_correction(plant, between=True)
    tr = sys_.tracker
    assert seen == dict(last=AT - 2, in_flight=[AT - 1, AT])
    assert planted == [AT - 1] and (AT - 1, "planted") in tr.loss_log
    after = [f for f in relocalized if f > AT - 1]
    assert after and after[0] <= AT + 1, relocalized  # the call's frame at the latest
    seen_by = {f for _, f, _ in sys_.frame_trajectory()} | set(after) | {f for f, _ in tr.loss_log}
    assert set(range(after[0], N)) <= seen_by, (sorted(seen_by), relocalized, tr.loss_log)


# ------------------------------------------------------- room circuit --

def test_room_circuit_closes_a_loop():
    from os1_tpu_torch.features.orb import OrbConfig
    from os1_tpu_torch.geometry.camera import Camera
    from os1_tpu_torch.io import synthetic
    from os1_tpu_torch.pipeline import System, TrackingState

    H, W = 240, 320
    K = np.array([[260.0, 0, 160.0], [0, 260.0, 120.0], [0, 0, 1.0]])
    poses = synthetic.loop_trajectory(160, radius=1.5, revolutions=1.15)
    frames = synthetic.render_sequence(synthetic.room_scene(seed=5), poses, K, H, W)
    cfg = SlamConfig(camera=Camera.make(260.0, 260.0, 160.0, 120.0, width=W, height=H,
                                        device="cpu"),
                     orb=OrbConfig(height=H, width=W, n_features=512, n_levels=4),
                     map=MapConfig(max_keyframes=64, max_points=8192, n_features=512))
    sys_ = System(cfg, device="cpu")
    est, gt = [], []
    for i, f in enumerate(frames):
        state, Tcw = sys_.track_monocular(f, timestamp=i / 30.0)
        if state == TrackingState.OK and Tcw is not None:
            est.append(Tcw)
            gt.append(poses[i])
    assert len(est) > 100, "tracking did not survive the circuit"
    assert sys_.loop_closer.n_loops_closed >= 1, "no loop closed"
    st = sys_.store
    assert np.isfinite(st.kf_T[st.kf_valid]).all()
    assert np.isfinite(st.pt_xyz[st.pt_valid]).all()
    ate = synthetic.ate_rmse(est, gt)
    path = np.linalg.norm(np.diff(np.array([-T[:3, :3].T @ T[:3, 3] for T in gt]), axis=0),
                          axis=1).sum()
    assert ate < 0.03 * path, f"ATE {ate:.4f} over {path:.2f}"
    assert len(sys_.loop_closer.loop_edges) >= 1
    for k in np.nonzero(st.kf_valid)[0]:
        p = st.kf_parent[k]
        assert p < 0 or st.kf_valid[p]


# --------------------------------------------------------------- card --

def _synthetic_candidate(n_feat=1024, n_pts=400, seed=0):
    """A current keyframe (1) and a loop candidate (2) seeing the same 400
    points, the current one through a Sim3 drift, as a program snapshot at
    the bench's width (1024 features, 4096 region slots)."""
    from os1_tpu_torch.geometry import sim3

    rng = np.random.default_rng(seed)
    world = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts),
                      rng.uniform(4, 8, n_pts)], 1).astype(np.float32)
    S12 = sim3.exp(torch.tensor([0.1, -0.05, 0.08, 0.02, -0.03, 0.01, 0.05])).numpy()
    x1 = world @ S12[:3, :3].T + S12[:3, 3]

    def project(x):
        return np.stack([400 * x[:, 0] / x[:, 2] + 320, 400 * x[:, 1] / x[:, 2] + 240], 1)

    desc_pts = rng.integers(0, 2**32, (n_pts, 8), dtype=np.uint64).astype(np.uint32)
    perm = rng.permutation(n_feat)[:n_pts]  # the candidate's feature of each point

    def frame(xyz, idx):
        desc = rng.integers(0, 2**32, (n_feat, 8), dtype=np.uint64).astype(np.uint32)
        desc[idx] = desc_pts
        xy = rng.uniform(0, 640, (n_feat, 2)).astype(np.float32)
        xy[idx] = project(xyz)
        xyz_f = np.zeros((n_feat, 3), np.float32)
        xyz_f[idx] = xyz
        bound = np.zeros(n_feat, bool)
        bound[idx] = True
        return dict(desc=desc, bound=bound, angle=np.zeros(n_feat, np.float32), xy=xy,
                    oct=np.zeros(n_feat, np.int32), xyz=xyz_f)

    f1, f2 = frame(x1, np.arange(n_pts)), frame(world, perm)
    region_desc = np.zeros((tlc.PROJ_CAP, 8), np.uint32)
    region_desc[:n_pts] = desc_pts
    region_xyz = np.zeros((tlc.PROJ_CAP, 3), np.float32)
    region_xyz[:n_pts] = world
    snap = {f"{k}1": v for k, v in f1.items()}
    snap.update({f"{k}2": v for k, v in f2.items()})
    snap["feat_valid1"] = np.ones(n_feat, bool)
    snap.update(region_desc=region_desc, region_xyz=region_xyz,
                region_ok=np.arange(tlc.PROJ_CAP) < n_pts, T_lw=np.eye(4, dtype=np.float32))
    return snap


@pytest.mark.cuda
def test_cuda_candidate_program_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the fused match kernel has no CPU mode)")
    from os1_tpu_torch.map.mirror import to_device
    from os1_tpu_torch.ops.pallas_hamming import gated_match_cuda
    from os1_tpu_torch.solvers.initializer import GumbelSampler

    snap = _synthetic_candidate()
    sigma2 = (1.2 ** (2 * np.arange(8))).astype(np.float32)
    intr = np.array([400.0, 400.0, 320.0, 240.0], np.float32)
    draws = {}

    def replay(valid, iters, k):  # the CPU run draws, the card's replays it
        if "idx" not in draws:
            draws["idx"] = GumbelSampler(seed=7, device="cpu")(valid.cpu(), iters, k)
        return draws["idx"].to(valid.device)

    out = {}
    for dev in ("cpu", "cuda"):
        before = gated_match_cuda.launches
        res = tlc.sim3_candidate_program(
            **{k: to_device(v, dev) for k, v in snap.items()}, intr=to_device(intr, dev),
            sigma2_table=to_device(sigma2, dev), sampler=replay)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert gated_match_cuda.launches == before + 2  # the match and the projection
        out[dev] = [x.cpu().numpy() for x in res]
    (hc, f1c, f2c, okc), (hg, f1g, f2g, okg) = out["cpu"], out["cuda"]
    assert hc[0] == 1.0 and hc[1] == 400 and hc[2] >= 40
    np.testing.assert_array_equal(hg[:4], hc[:4])
    np.testing.assert_array_equal(f1g, f1c)
    np.testing.assert_array_equal(f2g, f2c)
    np.testing.assert_array_equal(okg, okc)
    np.testing.assert_allclose(hg[4:20], hc[4:20], atol=1e-4)
